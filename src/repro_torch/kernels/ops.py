"""Public wrappers around the port's kernels (the counterparts of the JAX
package's ``kernels/ops.py``).

A CUDA tensor launches the Hopper kernel (or the kernel's wrapper raises);
a CPU tensor takes the kernel's plain version from ``ref``, and so does a
``meta`` tensor (the dry-run's shape pass, ``launch/dryrun.py``, which
computes nothing and counts the plain route's FLOPs and bytes).  The device
of the operands is the only thing that picks the path.  The ``*_tree`` forms
take a whole sweep over a tree's leaves: on the card one leaf-table call
per dtype, on the CPU the same per-leaf plain versions as the one-leaf
forms.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import tree as T
from repro_torch.kernels import compress as _cp
from repro_torch.kernels import fedadc_update as _fu
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import kd_loss as _kd
from repro_torch.kernels import ref
from repro_torch.kernels.ref import plain
from repro_torch.kernels import sparse_reduce as _sr
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import weighted_reduce as _wr

# the launching wrapper of every kernel, by the name the launch counts use
KERNELS = {
    "fused_axpy": _fu.fused_axpy_leaves,
    "local_update": _fu.local_update_leaves,
    "server_update": _fu.server_update_leaves,
    "weighted_reduce": _wr.weighted_reduce_leaves,
    "threshold_select": _cp.threshold_select_leaves,
    "qsgd": _cp.qsgd_leaves,
    "sparse_reduce": _sr.sparse_reduce_leaves,
    "kd_loss": _kd.kd_loss,
    "kd_loss_bwd": _kd.kd_loss_bwd,
    "flash_attention": _fa.flash_attention,
    "ssd_scan": _ssd.ssd_scan,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def fused_axpy(x, y, a):
    """x + a·y on a single leaf."""
    y = y.to(x.dtype)
    if plain(x):
        return ref.fused_axpy(x, y, a)
    return _fu.fused_axpy(x, y, a)


def _on_cpu(leaves, name):
    """True if a sweep's leaves all lie on the CPU (or all on ``meta``),
    False if all on the card; raises if they mix."""
    if all(t.is_cuda for t in leaves):
        return False
    if all(t.is_cpu for t in leaves) or all(t.is_meta for t in leaves):
        return True
    raise ValueError(f"{name}: leaves on mixed devices "
                     f"{sorted({str(t.device) for t in leaves})}")


def _per_dtype(keys, call):
    """``call(positions)`` for each group of positions sharing a key (one
    group, the common case, without regrouping) -> results in order."""
    if all(k == keys[0] for k in keys):
        return call(range(len(keys)))
    outs = [None] * len(keys)
    groups = {}
    for i, key in enumerate(keys):
        groups.setdefault(key, []).append(i)
    for pos in groups.values():
        for i, o in zip(pos, call(pos)):
            outs[i] = o
    return outs


def _like(tree, outs):
    """``outs`` (in leaf order) placed in a tree of ``tree``'s structure."""
    it = iter(outs)
    return T.tree_map(lambda _: next(it), tree)


def fused_axpy_tree(xs_tree, ys_tree, a):
    """x + a·y leaf by leaf over two trees of one structure (y cast to x's
    dtype): on the card one launch a dtype (per 64 leaves)."""
    xs, ys = T.leaves(xs_tree), T.leaves(ys_tree)
    ys = [y if y.dtype is x.dtype else y.to(x.dtype) for x, y in zip(xs, ys)]
    if _on_cpu(xs + ys, "fused_axpy"):
        return _like(xs_tree, [ref.fused_axpy(x, y, a)
                               for x, y in zip(xs, ys)])
    return _like(xs_tree, _per_dtype(
        [x.dtype for x in xs],
        lambda pos: _fu.fused_axpy_leaves([xs[i] for i in pos],
                                          [ys[i] for i in pos], a)))


def fedadc_local_update(theta, g, m_bar, eta):
    """θ − η(g + m̄) on a single leaf."""
    g, m_bar = g.to(theta.dtype), m_bar.to(theta.dtype)
    if plain(theta):
        return ref.fedadc_local_update(theta, g, m_bar, eta)
    return _fu.local_update(theta, g, m_bar, eta)


def fedadc_server_update(theta, m, delta_bar, gamma, alpha_eta):
    """(θ', m') fused server update on a single leaf; ``m`` and
    ``delta_bar`` fp32."""
    if plain(theta):
        return ref.fedadc_server_update(theta, m, delta_bar, gamma, alpha_eta)
    return _fu.server_update(theta, m, delta_bar, gamma, alpha_eta)


def fedadc_local_update_tree(theta_tree, g_tree, m_bar_tree, eta):
    """θ − η(g + m̄) leaf by leaf over three trees of one structure (g and
    m̄ cast to θ's dtype): on the card one launch a dtype (per 64 leaves)."""
    ts = T.leaves(theta_tree)
    gs = [g if g.dtype is t.dtype else g.to(t.dtype)
          for t, g in zip(ts, T.leaves(g_tree))]
    ms = [m if m.dtype is t.dtype else m.to(t.dtype)
          for t, m in zip(ts, T.leaves(m_bar_tree))]
    if _on_cpu(ts + gs + ms, "local_update"):
        return _like(theta_tree, [ref.fedadc_local_update(t, g, m, eta)
                                  for t, g, m in zip(ts, gs, ms)])
    return _like(theta_tree, _per_dtype(
        [t.dtype for t in ts],
        lambda pos: _fu.local_update_leaves([ts[i] for i in pos],
                                            [gs[i] for i in pos],
                                            [ms[i] for i in pos], eta)))


def fedadc_server_update_tree(theta_tree, m_tree, delta_tree, gamma,
                              alpha_eta, scale=1.0):
    """The server step over three trees of one structure: Δ̄ = scale·Δ
    (Δ in its own dtype, Δ̄ fp32), m' = Δ̄ + γ·m (m fp32), θ' = θ − αη·m'
    in θ's dtype -> (θ' tree, m' tree).  On the card one launch per (θ,
    Δ) dtype pair (per 64 leaves)."""
    ts, ms, ds = T.leaves(theta_tree), T.leaves(m_tree), T.leaves(delta_tree)
    if _on_cpu(ts + ms + ds, "server_update"):
        pairs = [ref.fedadc_server_update(t, m, d, gamma, alpha_eta, scale)
                 for t, m, d in zip(ts, ms, ds)]
    else:
        pairs = _per_dtype(
            [(t.dtype, d.dtype) for t, d in zip(ts, ds)],
            lambda pos: list(zip(*_fu.server_update_leaves(
                [ts[i] for i in pos], [ms[i] for i in pos],
                [ds[i] for i in pos], gamma, alpha_eta, scale))))
    return (_like(theta_tree, [t for t, _ in pairs]),
            _like(theta_tree, [m for _, m in pairs]))


def weighted_delta_reduce(deltas, weights):
    """Σ_k w_k·Δ_k on a single stacked leaf (leading axis K)."""
    if plain(deltas):
        return ref.weighted_delta_reduce(deltas, weights)
    return _wr.weighted_reduce(deltas, weights)


def weighted_delta_reduce_tree(deltas_tree, weights):
    """Σ_k w_k·Δ_k leaf by leaf over a stacked tree (leading axis K on
    every leaf), fp32 sums cast on write: on the card one launch a dtype
    (per 64 leaves)."""
    ds = T.leaves(deltas_tree)
    if _on_cpu(ds + [weights], "weighted_reduce"):
        return _like(deltas_tree, [ref.weighted_delta_reduce(d, weights)
                                   for d in ds])
    w = weights.float()
    return _like(deltas_tree, _per_dtype(
        [d.dtype for d in ds],
        lambda pos: _wr.weighted_reduce_leaves([ds[i] for i in pos], w)))


# ---------------------------------------------------------------------------
# delta compression: quantise/sparsify round trips of a leaf stacked over
# clients (B, ...), with one scalar per client row
# ---------------------------------------------------------------------------
def qsgd_compress_leaf(v, u, scale, s):
    """Stochastic uniform quantise-dequantise.  ``u`` the uniform draw (v's
    shape), ``scale`` (B,) each row's max magnitude, ``s`` the level count.
    -> (dequantised q, residual v − q)."""
    u = u.to(v.dtype)
    if plain(v):
        return ref.qsgd_quantize(v, u, scale, s)
    return _cp.qsgd(v.contiguous(), u.contiguous(), scale.contiguous(), s)


def qsgd_compress_tree(vs_tree, us_tree, s):
    """QSGD of every leaf of a tree of client-stacked leaves (B, ...), with
    the uniform draws ``us_tree`` (a tree of the same structure), each
    row's scale its max |v| -> (q tree, residual tree).  On the card one
    call a dtype: per 64 leaves one launch that computes the scales and
    quantises; on the CPU the per-leaf plain version with ``torch.amax``
    scales."""
    vs, us = T.leaves(vs_tree), T.leaves(us_tree)
    us = [u if u.dtype is v.dtype else u.to(v.dtype) for v, u in zip(vs, us)]
    if _on_cpu(vs + us, "qsgd"):
        pairs = [ref.qsgd_quantize(
            v, u, torch.amax(torch.abs(v.reshape(v.shape[0], -1)), dim=1), s)
            for v, u in zip(vs, us)]
    else:
        pairs = _per_dtype(
            [v.dtype for v in vs],
            lambda pos: list(zip(*_cp.qsgd_leaves(
                [vs[i].contiguous() for i in pos],
                [us[i].contiguous() for i in pos], s))))
    return (_like(vs_tree, [q for q, _ in pairs]),
            _like(vs_tree, [r for _, r in pairs]))


def topk_compress_leaf(v, thresh):
    """Magnitude-threshold select (top-k with τ (B,) precomputed).
    -> (selected q, residual v − q)."""
    if plain(v):
        return ref.topk_threshold_select(v, thresh)
    return _cp.threshold_select(v.contiguous(), thresh.contiguous())


def topk_compress_tree(vs_tree, taus_tree):
    """The magnitude-threshold select of every leaf of a tree of
    client-stacked leaves (B, ...), each with its rows' thresholds τ (B,)
    in ``taus_tree`` (a tree of the same structure; top-k's k-th largest
    |v| a row) -> (q tree, residual tree).  fp32 or bf16 leaves.  On the
    card one call a dtype, the group's τs concatenated to one fp32 vector
    (exact), one launch per 64 leaves; on the CPU the per-leaf plain
    version."""
    vs, taus = T.leaves(vs_tree), T.leaves(taus_tree)
    for v in vs:
        if v.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"threshold_select: dtype {v.dtype} not "
                             f"supported (float32, bfloat16)")
    if not vs or _on_cpu(vs + taus, "threshold_select"):
        pairs = [ref.topk_threshold_select(v, t) for v, t in zip(vs, taus)]
    else:
        pairs = _per_dtype(
            [v.dtype for v in vs],
            lambda pos: list(zip(*_cp.threshold_select_leaves(
                [vs[i].contiguous() for i in pos],
                torch.cat([taus[i] for i in pos]).float()))))
    return (_like(vs_tree, [q for q, _ in pairs]),
            _like(vs_tree, [r for _, r in pairs]))


def topk_sparse_leaf(v, k):
    """The true sparse top-k of each row of v (B, ...): the k largest-|v|
    entries leave as (values (B, k), flat indices (B, k) int32) — the wire
    itself — and the residual keeps everything else.  The residual zeroes
    exactly the gathered indices, so scatter(values, indices) + residual ==
    v bit for bit.  No kernel, as in the reference: ``torch.topk`` and a
    gather.  -> (values, indices, residual of v's shape)."""
    flat = v.reshape(v.shape[0], -1)
    idx = torch.topk(torch.abs(flat), k, dim=1).indices
    values = torch.gather(flat, 1, idx)
    residual = flat.scatter(1, idx, torch.zeros_like(values))
    return values, idx.to(torch.int32), residual.reshape(v.shape)


def sparse_scatter_leaf(values, indices, shape, dtype):
    """Server-side decode of the stacked sparse leaf (B, k): scatter each
    row's pairs into a dense zero leaf -> (B, *shape)."""
    n = 1
    for d in shape:
        n *= d
    out = torch.zeros((values.shape[0], n), dtype=dtype, device=values.device)
    out.scatter_(1, indices.long(), values.to(dtype))
    return out.reshape((values.shape[0],) + tuple(shape))


def sparse_weighted_delta_reduce(values, indices, weights, shape, dtype):
    """Σ_k w_k · scatter(values_k @ indices_k) for one leaf from the stacked
    (K, k) wire pairs, into the dense ``shape``/``dtype`` template: the
    sparse server aggregate at K·k cost, fp32 accumulation, cast on write."""
    if plain(values):
        return ref.sparse_weighted_delta_reduce(values, indices, weights,
                                                shape, dtype)
    return _sr.sparse_reduce(values.contiguous(),
                             indices.to(torch.int32).contiguous(),
                             weights.float().contiguous(), shape, dtype)


def sparse_weighted_delta_reduce_tree(values_tree, indices_tree, weights,
                                      like_tree):
    """``sparse_weighted_delta_reduce`` over every leaf of an aggregate:
    the stacked (K, k_l) wire pairs of each leaf into the dense shape and
    dtype of ``like_tree``'s leaf -> a tree of ``like_tree``'s structure.
    On the card one call (four kernels) per pair of value and output
    dtypes."""
    vals, idxs = T.leaves(values_tree), T.leaves(indices_tree)
    likes = T.leaves(like_tree)
    if _on_cpu(vals + idxs + [weights], "sparse_reduce"):
        return _like(like_tree, [
            ref.sparse_weighted_delta_reduce(v, i, weights, tuple(l.shape),
                                             l.dtype)
            for v, i, l in zip(vals, idxs, likes)])
    w = weights.float()
    idxs = [i if i.dtype is torch.int32 else i.to(torch.int32) for i in idxs]
    return _like(like_tree, _per_dtype(
        [(v.dtype, l.dtype) for v, l in zip(vals, likes)],
        lambda pos: _sr.sparse_reduce_leaves(
            [vals[i] for i in pos], [idxs[i] for i in pos], w,
            [likes[i].shape for i in pos], likes[pos[0]].dtype)))


# ---------------------------------------------------------------------------
# self-confidence KD loss (FedADC+), differentiable in the student logits
# ---------------------------------------------------------------------------
def kd_loss(student_logits, teacher_logits, labels, rho, lam, tau):
    """Per-row FedADC+ loss of logits (B, C), labels (B,) and ρ (C,) ->
    (loss, ce, kl), each (B,) fp32, ``kl`` with its τ² factor.  Gradients
    reach the student logits through ``loss`` (the backward kernel on the
    card); the teacher and ρ are constants.  Works under
    ``torch.func.vmap``: the vmapped calls of all clients make one launch."""
    loss, ce, kl, _ = _kd.KDLoss.apply(student_logits, teacher_logits,
                                       labels, rho.reshape(1, -1), lam, tau)
    return loss, ce, kl


# ---------------------------------------------------------------------------
# attention and the SSD scan (the LM forward's ``use_pallas=True`` route)
# ---------------------------------------------------------------------------
def _refuse_grad(name, *tensors):
    """Raise where autograd would have to differentiate through a kernel
    that has no backward.  The reference refuses the same way (``jax.grad``
    through its Pallas kernel raises), so a caller that trains takes the
    plain route (``use_pallas=False``) instead of getting no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (the reference's "
            f"Pallas kernel has none either); call it under torch.no_grad() "
            f"or on tensors that do not require grad, or train with "
            f"use_pallas=False")


def flash_attention(q, k, v, causal=True, window=0):
    """q (B, L, H, D), k/v (B, L, Hk, D) in the model's layout -> (B, L, H,
    D) in q's dtype.  On the card it refuses operands that need a
    gradient (``_refuse_grad``)."""
    if plain(q):
        out = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal, window)
        return out.transpose(1, 2)
    _refuse_grad("flash_attention", q, k, v)
    return _fa.flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal, window)


def ssd_scan(x, dt, A_log, B, C, D, chunk=256):
    """The chunked SSD of a Mamba2 block: x (b, L, H, P), dt (b, L, H), B/C
    (b, L, H, N), A_log and D (H,) -> y (b, L, H, P) fp32.  As in the
    reference, the prologue (x·dt and the log decay) and the D skip stay
    outside the kernel, and the kernel's output is rounded to x's dtype
    before the fp32 D term is added (``ssd_scan.py:66-73, 91-93``).  On the
    card it refuses kernel operands that need a gradient."""
    chunk = min(chunk, x.shape[1])
    xdt, a = ref.ssd_prologue(x, dt, A_log)
    if plain(x):
        y = ref.ssd_recurrence(xdt, a, B, C).to(x.dtype)
    else:
        _refuse_grad("ssd_scan", xdt, a, B, C)
        y = _ssd.ssd_scan(xdt.contiguous(), a.contiguous(), B.contiguous(),
                          C.contiguous(), chunk, x.dtype)
    return y.float() + D.float()[None, None, :, None] * xdt
