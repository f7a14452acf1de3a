"""Plain PyTorch versions of the port's kernels (the counterparts of the
JAX package's ``kernels/ref.py``).

Each repeats its CUDA kernel's arithmetic: fp32 whatever the storage type,
every multiply and add rounded on its own, one rounding to the output type
on write, and the reduces summed client by client in order (QSGD instead
rounds to its operand dtype after every operation, as the reference's jnp
ops do; the threshold select only masks).  So on
the same inputs a kernel and its plain version agree bit for bit.  The
self-confidence KD loss, flash attention and the SSD scan are the
exceptions: their kernels sum in another order (online softmax over key
tiles; chunked instead of sequential), so each agrees with its plain
version within fp32 rounding, not bit for bit.  The CPU runs these; on the card they
are the yardstick the kernels are held to.
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least fp32, never a downcast (float64 stays float64)."""
    return torch.promote_types(dtype, torch.float32)


def fused_axpy(x, y, a):
    """x + a·y."""
    acc = acc_dtype(x.dtype)
    return (x.to(acc) + a * y.to(acc)).to(x.dtype)


def fedadc_local_update(theta, g, m_bar, eta):
    """Heavy-ball embedded step (Alg. 3 blue): θ − η(g + m̄)."""
    acc = acc_dtype(theta.dtype)
    return (theta.to(acc) - eta * (g.to(acc) + m_bar.to(acc))).to(theta.dtype)


def fedadc_server_update(theta, m, delta, gamma, alpha_eta, scale=1.0):
    """Alg. 3 lines 16, 17, 19: Δ̄ = scale·Δ ; m' = Δ̄ + γ·m ; θ' = θ −
    αη·m'.  -> (θ', m').  Δ̄ and m' take m's (fp32) dtype; θ' takes θ's.
    ``scale`` 1 leaves Δ as it is (x·1 is exact)."""
    m_new = delta.to(m.dtype) * scale + gamma * m
    acc = acc_dtype(theta.dtype)
    return (theta.to(acc) - alpha_eta * m_new).to(theta.dtype), m_new


def weighted_delta_reduce(deltas, weights):
    """Σ_k w_k·Δ_k for one stacked tensor (K, ...), summed in at least fp32
    in client order and cast back to the delta dtype on write."""
    acc_t = acc_dtype(deltas.dtype)
    w = weights.to(acc_t)
    acc = torch.zeros(deltas.shape[1:], dtype=acc_t, device=deltas.device)
    for k in range(deltas.shape[0]):
        acc = acc + w[k] * deltas[k].to(acc_t)
    return acc.to(deltas.dtype)


def sparse_weighted_delta_reduce(values, indices, weights, shape, dtype):
    """Σ_k w_k · scatter(values_k @ indices_k) for one leaf from the stacked
    (K, k) wire pairs of K clients, into a dense tensor of ``shape`` and
    ``dtype``.  The weighted pairs are added into an fp32 zero buffer in
    client-major order and, within a client, in pair order (a duplicate
    index adds again, segment-sum semantics); the buffer is cast once, on
    write.  Pairs whose index lies outside [0, n) add nothing, as
    ``segment_sum`` drops them in the reference.

    ``index_add_`` gives no order among duplicates within one call on the
    card (it adds with atomics), so each client's pairs are applied in
    rounds of unique indices: round r takes every pair that is the r-th
    occurrence of its index.  A top-k wire has unique indices, one round."""
    n = 1
    for d in shape:
        n *= d
    acc_t = acc_dtype(values.dtype)
    out = torch.zeros((n,), dtype=acc_t, device=values.device)
    w = weights.to(acc_t)
    for c in range(values.shape[0]):
        idx = indices[c].long()
        wv = w[c] * values[c].to(acc_t)
        keep = (idx >= 0) & (idx < n)
        if not bool(keep.all()):
            idx, wv = idx[keep], wv[keep]
        rank = _occurrence_rank(idx)
        for r in range(int(rank.max()) + 1 if idx.numel() else 0):
            sel = rank == r
            out.index_add_(0, idx[sel], wv[sel])
    return out.to(dtype).reshape(shape)


def _occurrence_rank(idx):
    """For each position, how many earlier positions hold the same index."""
    order = torch.sort(idx, stable=True).indices
    sorted_idx = idx[order]
    pos = torch.arange(idx.numel(), device=idx.device)
    new_run = torch.ones_like(sorted_idx, dtype=torch.bool)
    new_run[1:] = sorted_idx[1:] != sorted_idx[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - run_start
    return rank


def qsgd_quantize(v, u, scale, s):
    """QSGD stochastic uniform quantise-dequantise of a leaf stacked over
    clients: ``v`` and the uniform draw ``u`` are (B, ...), ``scale`` (B,)
    is each row's max magnitude, ``s`` the number of magnitude levels.
    -> (dequantised q, residual v − q).

    Every operation runs in v's dtype, rounding after each as the
    reference's jnp ops do (so bf16 rounds at every step).  The level count
    and the floor 1e-30 are device tensors, not Python scalars: divided by
    a host scalar PyTorch may multiply by its reciprocal instead."""
    shape = (-1,) + (1,) * (v.dim() - 1)
    scale = scale.reshape(shape)
    s_t = torch.full_like(scale, float(s))
    inv = torch.where(scale > 0,
                      s_t / torch.maximum(scale, torch.full_like(scale, 1e-30)),
                      torch.zeros_like(scale))
    y = torch.abs(v) * inv
    lower = torch.floor(y)
    level = lower + (u < (y - lower)).to(v.dtype)
    q = torch.sign(v) * level * (scale / s_t)
    return q, v - q


def topk_threshold_select(v, thresh):
    """Magnitude-threshold select of a leaf stacked over clients (top-k with
    τ = each row's k-th largest |v|, ``thresh`` (B,)).
    -> (selected q, residual v − q)."""
    t = thresh.reshape((-1,) + (1,) * (v.dim() - 1))
    q = torch.where(torch.abs(v) >= t, v, torch.zeros_like(v))
    return q, v - q


# ---------------------------------------------------------------------------
# self-confidence KD loss (FedADC+, eqs. (7)-(9)), forward and backward
# ---------------------------------------------------------------------------
# per-row statistics the forward hands the backward, in this column order
KD_STATS = ("lse", "lse_tau", "lse_teacher", "true_mass", "target_sum")


def one_hot(labels, n_classes):
    """(..., C) fp32 one-hot of int labels, by comparison: unlike
    ``F.one_hot`` it reads no value on the host, so it works under vmap and
    does not wait for the card."""
    classes = torch.arange(n_classes, device=labels.device)
    return (labels.long()[..., None] == classes).float()


def row_rho(rho, rows):
    """ρ of every row: ``rho`` (C,) for all rows, or (G, C) with rows/G
    consecutive rows per group -> (rows, C) fp32."""
    rho = rho.float().reshape(-1, rho.shape[-1])
    if rows % rho.shape[0]:
        raise ValueError(f"kd_loss: {rows} rows do not split into "
                         f"{rho.shape[0]} groups")
    return rho.repeat_interleave(rows // rho.shape[0], dim=0)


def kd_loss(student_logits, teacher_logits, labels, rho, lam, tau):
    """Per-row (1 − λ)·CE + λ·τ²·KL(target ‖ softmax(s/τ)), the target built
    from the teacher's softmax at τ damped by (1 − ρ) with the leftover mass
    on the true class (eqs. (8)-(9)).  ``rho`` is (C,) or (G, C) (see
    ``row_rho``).  -> (loss, ce, kl, stats), each (B,) fp32 but ``stats``
    (B, 5) fp32 in ``KD_STATS`` order; ``kl`` carries the τ² factor."""
    s = student_logits.float()
    t = teacher_logits.float()
    C = s.shape[-1]
    rho = row_rho(rho, s.shape[0])
    p_t = torch.softmax(t / tau, -1)
    onehot = one_hot(labels, C)
    damp = (1.0 - rho) * p_t
    non_true = damp * (1.0 - onehot)
    true_mass = 1.0 - non_true.sum(-1, keepdim=True)
    target = non_true + onehot * true_mass
    # CE
    lse = torch.logsumexp(s, -1)
    gold = torch.sum(s * onehot, -1)
    ce = lse - gold
    # KL(target ‖ student_T)
    st = s / tau
    lse_tau = torch.logsumexp(st, -1)
    logp = st - lse_tau[:, None]
    tgt = torch.clamp(target, 1e-9, 1.0)
    kl = torch.sum(tgt * (torch.log(tgt) - logp), -1) * tau ** 2
    stats = torch.stack([lse, lse_tau, torch.logsumexp(t / tau, -1),
                         true_mass[:, 0], tgt.sum(-1)], -1)
    return (1 - lam) * ce + lam * kl, ce, kl, stats


def kd_loss_bwd(student_logits, teacher_logits, labels, rho, stats, g, lam,
                tau):
    """∂(Σ_i g_i·loss_i)/∂s in closed form from the forward's row ``stats``:

        g_i·[(1−λ)(softmax(s)_j − 1[j=y]) + λ·τ·(S·softmax(s/τ)_j − tgt_j)]

    with tgt the clipped target and S = Σ_j tgt_j (the clip means S need
    not be 1).  The target is a constant (the reference's stop_gradient):
    nothing flows to the teacher or ρ.  -> ∂/∂s in the logits' dtype."""
    s = student_logits.float()
    t = teacher_logits.float()
    C = s.shape[-1]
    rho = row_rho(rho, s.shape[0])
    lse, lse_tau, lse_teacher, true_mass, target_sum = (
        c[:, None] for c in stats.float().unbind(-1))
    onehot = one_hot(labels, C)
    p = torch.exp(s - lse)
    p_tau = torch.exp(s / tau - lse_tau)
    p_t = torch.exp(t / tau - lse_teacher)
    tgt = torch.clamp(torch.where(onehot > 0, true_mass, (1.0 - rho) * p_t),
                      1e-9, 1.0)
    ds = g.float()[:, None] * ((1 - lam) * (p - onehot)
                               + lam * tau * (target_sum * p_tau - tgt))
    return ds.to(student_logits.dtype)


# ---------------------------------------------------------------------------
# flash attention (causal, GQA, optional sliding window)
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, causal=True, window=0):
    """q (B, H, L, D), k/v (B, Hk, L, D) -> (B, H, L, D) in q's dtype:
    the masked softmax in fp32 over the whole (L, L) score matrix, as the
    reference's oracle computes it (``ref.py:87-110``)."""
    B, H, Lq, D = q.shape
    g = H // k.shape[1]
    qf = q.float() * (D ** -0.5)
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    qpos = torch.arange(Lq, device=q.device)[:, None]
    kpos = torch.arange(Lq, device=q.device)[None, :]
    mask = torch.ones((Lq, Lq), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vf).to(q.dtype)


# ---------------------------------------------------------------------------
# SSD scan (sequential recurrence)
# ---------------------------------------------------------------------------
def ssd_recurrence(xdt, a, B, C):
    """The SSD kernel's plain version: xdt (b, L, H, P) fp32 (x·dt), a (b,
    L, H) fp32 (the per-step log decay), B/C (b, L, H, N) -> y (b, L, H, P)
    fp32 by the sequential recurrence h_t = e^{a_t}·h_{t−1} + B_tᵀ·x_t,
    y_t = C_t·h_t, one position at a time, without the D term."""
    b, L, H, P = xdt.shape
    N = B.shape[-1]
    Bf, Cf, decay = B.float(), C.float(), torch.exp(a.float())
    h = torch.zeros((b, H, N, P), dtype=torch.float32, device=xdt.device)
    ys = []
    for t in range(L):
        h = (h * decay[:, t, :, None, None]
             + Bf[:, t, :, :, None] * xdt[:, t, :, None, :])
        ys.append(torch.einsum("bhn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1)


def _chunked(t, chunk):
    """(b, L, H, ...) -> (b, chunks, chunk, H, ...) fp32, zero-padded past L."""
    L = t.shape[1]
    n_chunks = -(-L // chunk)
    pad = torch.zeros((t.shape[0], n_chunks * chunk - L) + t.shape[2:],
                      dtype=torch.float32, device=t.device)
    t = torch.cat([t.float(), pad], dim=1)
    return t.reshape((t.shape[0], n_chunks, chunk) + t.shape[2:])


def ssd_chunk_states(xdt, a, B, chunk):
    """The SSD kernel's first phase: per (batch, head) and chunk of
    ``chunk`` positions (the last one zero-padded past L) the running sums
    acum of the log decay within the chunk, in float64, and the chunk's
    state S_c = Σ_j B_jᵀ·e^{a_end − acum_j}·x_j, each gate's difference
    taken in float64 and rounded once to fp32.
    -> (acum (b, H, chunks, chunk) float64, S (b, H, chunks, N, P) fp32)."""
    acum = torch.cumsum(_chunked(a, chunk).double(), dim=2).permute(0, 3, 1, 2)
    w = torch.exp((acum[..., -1:] - acum).float())
    S = torch.einsum("bcqhn,bhcq,bcqhp->bhcnp", _chunked(B, chunk), w,
                     _chunked(xdt, chunk))
    return acum, S


def ssd_state_pass(S, acum):
    """The second phase: the state before each chunk, h_0 = 0 and
    h_c = e^{a_end,c−1}·h_{c−1} + S_{c−1} -> (b, H, chunks, N, P) fp32."""
    decay = torch.exp(acum[..., -1]).float()
    h = torch.zeros_like(S[:, :, 0])
    before = []
    for c in range(S.shape[2]):
        before.append(h)
        h = decay[:, :, c, None, None] * h + S[:, :, c]
    return torch.stack(before, dim=2)


def ssd_chunk_outputs(xdt, B, C, acum, h_prev, chunk):
    """The third phase: within each chunk y_i = Σ_{j≤i} (C_i·B_j)
    e^{acum_i − acum_j} x_j + e^{acum_i} C_i·h_prev -> (b, L, H, P) fp32."""
    L = xdt.shape[1]
    Bc, Cc = _chunked(B, chunk), _chunked(C, chunk)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=xdt.device))
    diff = (acum[..., :, None] - acum[..., None, :]).float()
    gate = torch.exp(torch.where(causal, diff, torch.zeros_like(diff)))
    scores = torch.einsum("bcqhn,bckhn->bhcqk", Cc, Bc)
    scores = torch.where(causal, scores * gate, torch.zeros_like(scores))
    y = torch.einsum("bhcqk,bckhp->bcqhp", scores, _chunked(xdt, chunk))
    carried = torch.einsum("bcqhn,bhcnp->bcqhp", Cc, h_prev)
    y = y + carried * torch.exp(acum).float().permute(0, 2, 3, 1)[..., None]
    return y.reshape((y.shape[0], -1) + y.shape[3:])[:, :L]


def ssd_chunked_scan(xdt, a, B, C, chunk):
    """The SSD kernel's three phases composed -> y (b, L, H, P) fp32,
    without the D term: the chunked counterpart of ``ssd_recurrence``."""
    acum, S = ssd_chunk_states(xdt, a, B, chunk)
    return ssd_chunk_outputs(xdt, B, C, acum, ssd_state_pass(S, acum), chunk)


def ssd_prologue(x, dt, A_log):
    """The elementwise prologue the SSD kernel leaves to its caller:
    -> (x·dt, −exp(A_log)·dt), both fp32."""
    dtf = dt.float()
    xdt = x.float() * dtf[..., None]
    a = -torch.exp(A_log.float())[None, None] * dtf
    return xdt, a


def ssd_scan(x, dt, A_log, B, C, D, chunk=None):
    """The reference's sequential oracle (``ref.py:113-137``): x (b, L, H,
    P), dt (b, L, H), B/C (b, L, H, N), A_log and D (H,) -> y (b, L, H, P)
    fp32, D skip included.  ``chunk`` is ignored."""
    xdt, a = ssd_prologue(x, dt, A_log)
    y = ssd_recurrence(xdt, a, B, C)
    return y + D.float()[None, None, :, None] * xdt
