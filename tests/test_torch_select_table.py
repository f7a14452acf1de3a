"""The top-k threshold select over whole trees: one call a compress,
described to the card by QSGD's leaf table with each row's threshold in the
scale's place (``kernels/compress.py``, ``csrc/compress_kernels.cu``).

On the CPU the tree form (``ops.topk_compress_tree``) runs the per-leaf
plain version, so it is held bit for bit against that and, at
``test_kernels.py``'s bar (bit for bit), against the JAX package's
``threshold_select_2d`` (its Pallas kernel in interpret mode); the
compressor that calls it is held bit for bit against the per-leaf path it
replaced and against the JAX package's top-k compressor.  The table's
layout is pure Python: a model of the kernel's indexing, run here over the
plan, checks its rows, ends and threshold order.  The kernel that reads the
table needs the card (``tests/test_torch_gpu.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import compression as JC
from repro.kernels import ops as jops
from repro.models.vision import cnn_init as jcnn_init
from repro_torch.core import tree as T
from repro_torch.federated import compression as C
from repro_torch.kernels import compress as CP
from repro_torch.kernels import leaf_table as LT
from repro_torch.kernels import ops, ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# a conv kernel, a bias, a scalar, an empty leaf, lengths off the 4096 tile
SHAPES = {"c1": {"w": (3, 3, 3, 5), "b": (5,)}, "s": (), "e": (0, 4),
          "d": {"w": (4097,), "b": (4095,)}}
K = 3


def stacked(seed, dtype, shapes=SHAPES, k=K):
    rng = np.random.RandomState(seed)
    return T.tree_map(
        lambda s: torch.from_numpy(rng.randn(k, *s).astype(np.float32)
                                   ).to(dtype), shapes)


def thresholds(v_tree, frac=0.1):
    """Each row's k-th largest |v| (0 for an empty leaf), in v's dtype."""
    def tau(x):
        flat = x.reshape(x.shape[0], -1).abs()
        if not flat.shape[1]:
            return torch.zeros(x.shape[0], dtype=x.dtype)
        k = max(1, math.ceil(frac * flat.shape[1]))
        return torch.topk(flat, k, dim=1).values[:, -1]
    return T.tree_map(tau, v_tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_compress_tree_equals_per_leaf_plain(dtype):
    """Bit for bit the per-leaf plain version and the one-leaf form, q + r
    == v, no launch on the CPU, the tree's structure kept."""
    dt = DTYPES[dtype]
    v = stacked(0, dt)
    taus = thresholds(v)
    ops.reset_launch_counts()
    q, r = ops.topk_compress_tree(v, taus)
    assert ops.launch_counts()["threshold_select"] == 0
    assert list(q) == list(v) and list(r["d"]) == ["w", "b"]
    for qi, ri, vi, ti in zip(T.leaves(q), T.leaves(r), T.leaves(v),
                              T.leaves(taus)):
        assert qi.dtype == ri.dtype == dt and qi.shape == vi.shape
        for want_q, want_r in (ref.topk_threshold_select(vi, ti),
                               ops.topk_compress_leaf(vi, ti)):
            assert torch.equal(qi, want_q) and torch.equal(ri, want_r)
        assert torch.equal(qi + ri, vi)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_topk_compress_tree_matches_jax_pallas(dtype):
    """Row by row, bit for bit against the JAX package's
    ``threshold_select_2d`` (interpret mode) with the same threshold; the
    empty leaf is left out (the reference's wrapper cannot tile it)."""
    dt = DTYPES[dtype]
    shapes = {k: s for k, s in SHAPES.items() if k != "e"}
    v = stacked(1, dt, shapes, k=2)
    taus = thresholds(v)
    q, r = ops.topk_compress_tree(v, taus)
    for qi, ri, vi, ti in zip(T.leaves(q), T.leaves(r), T.leaves(v),
                              T.leaves(taus)):
        for row in range(vi.shape[0]):
            jq, jr = jops.topk_compress_leaf(
                jnp.asarray(vi[row].float().numpy(), JAX_DT[dt]),
                jnp.asarray(float(ti[row]), JAX_DT[dt]))
            np.testing.assert_array_equal(
                qi[row].float().numpy(), np.asarray(jq.astype(jnp.float32)))
            np.testing.assert_array_equal(
                ri[row].float().numpy(), np.asarray(jr.astype(jnp.float32)))


def cnn_pair(seed, k):
    """A small CNN-shaped delta and EF tree stacked over k clients: (JAX
    tree of (k, ...) arrays, port tree of (k, ...) tensors, conv weights
    OIHW)."""
    params = jax.eval_shape(lambda: jcnn_init(
        jax.random.PRNGKey(seed), n_classes=10, width=4, image_size=16))
    rng = np.random.RandomState(seed)

    def draw(p):
        return jax.tree.map(
            lambda x: rng.randn(k, *x.shape).astype(np.float32), p)

    def port(tree):
        def leaf(a):
            if a.ndim == 5:                        # (k, H, W, I, O)
                a = a.transpose(0, 4, 3, 1, 2)
            return torch.from_numpy(np.ascontiguousarray(a))
        return jax.tree.map(leaf, tree)
    jd, je = draw(params), draw(params)
    return (jd, je), (port(jd), port(je))


def to_jax_layout(tree):
    def leaf(t):
        a = t.numpy()
        return a.transpose(0, 3, 4, 2, 1) if a.ndim == 5 else a
    return jax.tree.map(leaf, tree)


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_topk_compressor_unchanged_and_matches_jax(frac):
    """The compressor's one tree call gives, bit for bit, the q and EF
    residual of the per-leaf path it replaced (a ``torch.topk`` and a
    one-leaf select a leaf), and the JAX package's top-k compressor's."""
    (jd, je), (td, te) = cnn_pair(2, 4)
    comp = C.TopKCompressor(frac)
    q, ef = comp.compress(td, te, None)

    def before(x):
        flat = torch.abs(x.reshape(x.shape[0], -1))
        tau = torch.topk(flat, comp._k(flat.shape[1]), dim=1).values[:, -1]
        return ops.topk_compress_leaf(x, tau)
    q0, ef0 = T.unzip2(T.tree_map(before, T.add(td, te)))
    for a, b in zip(T.leaves(q) + T.leaves(ef), T.leaves(q0) + T.leaves(ef0)):
        assert torch.equal(a, b)
    jq, jef = jax.jit(jax.vmap(lambda d, e: JC.TopKCompressor(frac).compress(
        d, e, None)))(jd, je)
    jax.tree.map(np.testing.assert_array_equal, to_jax_layout(q), jq)
    jax.tree.map(np.testing.assert_array_equal, to_jax_layout(ef), jef)


def run_plan_on_cpu(vs, taus, dtype):
    """The select kernel's indexing, modelled over the plan the wrapper
    hands the card: each group of 64 leaves, each block's leaf (the first
    whose block end exceeds it), row and tile, its threshold at the group's
    row offset plus the leaf's row start plus the row, q and r written at
    the rows' byte offsets of one buffer.  -> (qs, rs) as the wrapper's
    views, and how often each element of the buffer was written."""
    rows, half, views, totals = CP._qsgd_plan(
        tuple(tuple(v.shape) for v in vs), dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    out = torch.zeros(2 * half, dtype=dtype)
    hits = torch.zeros(2 * half, dtype=torch.int64)
    tau_base = 0
    for g0 in range(0, len(vs), LT.MAX_LEAVES):
        grp = rows[g0:g0 + LT.MAX_LEAVES]
        row_end, block_end = grp[:, 5].tolist(), grp[:, 6].tolist()
        for b in range(block_end[-1]):
            leaf = next(i for i, e in enumerate(block_end) if e > b)
            local = b - (block_end[leaf - 1] if leaf else 0)
            n = int(grp[leaf, 4])
            tiles = LT.cdiv(n, CP.QSGD_TILE)
            row, lo = local // tiles, (local % tiles) * CP.QSGD_TILE
            hi = min(n, lo + CP.QSGD_TILE)
            th = taus[tau_base + (row_end[leaf - 1] if leaf else 0) + row]
            x = vs[g0 + leaf].reshape(-1)[row * n + lo:row * n + hi].float()
            keep = torch.where(x.abs() >= th, x, torch.zeros_like(x))
            for col, vals in ((2, keep), (3, x - keep)):
                at = int(grp[leaf, col]) // esize + row * n + lo
                out[at:at + hi - lo] = vals.to(dtype)
                hits[at:at + hi - lo] += 1
        tau_base += row_end[-1]
    assert tau_base == sum(t[0] for t in totals)
    return CP._views(out, half, views), hits, half


@pytest.mark.parametrize("n_leaves", [1, 64, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_select_plan_rows_ends_and_threshold_order(n_leaves, dtype):
    """The plan (QSGD's: v, u unused, q's and r's byte offsets, n, row end,
    block end, the ends restarting every 64 leaves) read as the kernel
    reads it, with one fp32 threshold per row of every leaf in order,
    gives the per-leaf plain version bit for bit and writes every element
    of every leaf's q and r once; one launch per group with a block."""
    dt = DTYPES[dtype]
    lengths = [1, 7, 4096, 4097, 0, 8193, 30]
    rng = np.random.RandomState(n_leaves)
    vs = [torch.from_numpy(rng.randn(2 + i % 2, lengths[i % len(lengths)])
                           .astype(np.float32)).to(dt)
          for i in range(n_leaves)]
    tau_list = [torch.from_numpy(rng.rand(v.shape[0]).astype(np.float32)
                                 ).to(dt) for v in vs]
    taus = torch.cat(tau_list).float()
    (qs, rs), hits, half = run_plan_on_cpu(vs, taus, dt)
    for v, t, q, r in zip(vs, tau_list, qs, rs):
        want_q, want_r = ref.topk_threshold_select(v, t)
        assert torch.equal(q, want_q) and torch.equal(r, want_r)
    assert int(hits.max()) <= 1
    assert int(hits.sum()) == 2 * sum(v.numel() for v in vs)
    _, _, _, totals = CP._qsgd_plan(tuple(tuple(v.shape) for v in vs), dt)
    assert len(totals) == LT.cdiv(n_leaves, LT.MAX_LEAVES)
    assert sum(1 for t in totals if t[1]) == LT.cdiv(n_leaves, LT.MAX_LEAVES)


def test_select_refuses_cpu_leaves_mixed_devices_and_other_dtypes():
    """The table wrapper takes CUDA leaves of fp32 or bf16 only; the tree
    form keeps CPU leaves on the plain version, refuses a sweep over two
    devices and a dtype the kernel does not take on either route."""
    v = torch.randn(4, 10)
    tau = torch.rand(4)
    with pytest.raises(ValueError, match="CUDA"):
        CP.threshold_select_leaves([v], tau)
    with pytest.raises(ValueError, match="not supported"):
        CP.threshold_select_leaves([v.double()], tau)
    assert CP.threshold_select_leaves([], tau) == ([], [])
    with pytest.raises(ValueError, match="mixed devices"):
        ops.topk_compress_tree({"a": v}, {"a": torch.rand(4, device="meta")})
    with pytest.raises(ValueError, match="not supported"):
        ops.topk_compress_tree({"a": v.double()}, {"a": tau.double()})
    assert ops.topk_compress_tree({}, {}) == ({}, {})
