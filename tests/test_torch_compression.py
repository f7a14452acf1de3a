"""The port's compression kernels and compressors, held against the JAX
package.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the plain
PyTorch versions; each is compared with the reference's Pallas kernel in
interpret mode (``repro.kernels.ops``) and with its jnp oracle
(``repro.kernels.ref``) on the same numpy inputs, the QSGD uniforms drawn
with JAX.  Bars:

* threshold select: bit for bit, and q + r == v bit for bit;
* QSGD: ``test_kernels.py``'s tolerances, 1e-5 in fp32 and 2e-2 in bf16
  (both round every op in the operand dtype, but XLA may fuse where torch
  does not), the one-step error bound, and exact zeros on a zero leaf;
* sparse reduce: bit for bit (both add the weighted pairs into an fp32 zero
  buffer in client-major, then pair order), and at K=96 bf16 within one
  bf16 ulp of an fp64 oracle;
* the compressors over a client-stacked tree: top-k bit for bit, QSGD at
  1e-5, and their wire bytes equal to the reference's exactly.

The CUDA kernels need the card: ``tests/test_torch_gpu.py`` holds each
against its plain version there and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.federated import compression as JC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.vision import cnn_init as jcnn_init
from repro_torch.configs.base import FedConfig
from repro_torch.federated import compression as C
from repro_torch.kernels import ops

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def as_torch(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def operand(seed, n, dtype):
    """(torch, jax) copies of one random leaf representable in `dtype`."""
    a = np.random.RandomState(seed).randn(n).astype(np.float32)
    t = as_torch(a, dtype)
    return t, jnp.asarray(t.float().numpy(), JAX_DT[dtype])


# ---------------------------------------------------------------------------
# threshold select
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k", [(128, 13), (1000, 100), (4097, 1),
                                 (65536, 6554)])
def test_threshold_select_matches_reference(n, k):
    t, j = operand(9, n, "float32")
    thresh = jax.lax.top_k(jnp.abs(j), k)[0][-1]
    q, r = ops.topk_compress_leaf(t[None], torch.tensor([float(thresh)]))
    for qe, re in (jops.topk_compress_leaf(j, thresh),
                   jref.topk_threshold_select(j, thresh)):
        np.testing.assert_array_equal(as_np(q[0]), as_np(qe))
        np.testing.assert_array_equal(as_np(r[0]), as_np(re))
    assert int(torch.sum(q != 0)) == k
    assert torch.equal(q + r, t[None])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_threshold_select_per_row(dtype):
    """A stacked leaf takes one τ per client row."""
    rows = [operand(s, 300, dtype) for s in range(4)]
    v = torch.stack([t for t, _ in rows])
    tau = torch.topk(v.abs(), 30, dim=1).values[:, -1]
    q, r = ops.topk_compress_leaf(v, tau)
    for i, (_, j) in enumerate(rows):
        qe, re = jref.topk_threshold_select(j, jnp.asarray(float(tau[i]),
                                                           JAX_DT[dtype]))
        np.testing.assert_array_equal(as_np(q[i]), as_np(qe))
        np.testing.assert_array_equal(as_np(r[i]), as_np(re))
    assert torch.equal(q + r, v)


# ---------------------------------------------------------------------------
# QSGD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1000, 65536])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qsgd_matches_reference(n, bits, dtype):
    ks = jax.random.split(jax.random.PRNGKey(8), 2)
    j = jax.random.normal(ks[0], (n,), JAX_DT[dtype])
    u = jax.random.uniform(ks[1], (n,), dtype=JAX_DT[dtype])
    scale = jnp.max(jnp.abs(j))
    s = (1 << bits) - 1
    v_t, u_t = as_torch(as_np(j), dtype), as_torch(as_np(u), dtype)
    q, r = ops.qsgd_compress_leaf(v_t[None], u_t[None],
                                  torch.amax(v_t.abs())[None], s)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    for qe, re in (jops.qsgd_compress_leaf(j, u, scale, s),
                   jref.qsgd_quantize(j, u, scale, s)):
        np.testing.assert_allclose(as_np(q[0]), as_np(qe), atol=tol, rtol=tol)
        np.testing.assert_allclose(as_np(r[0]), as_np(re), atol=tol, rtol=tol)
    # the reconstruction error is within one quantisation step (plus the
    # dtype's rounding of the levels)
    step = float(scale) / s
    eps = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -23
    bound = step * (1 + 1e-3) + 2 * float(scale) * eps + 1e-6
    assert np.all(np.abs(as_np(v_t - q[0])) < bound)


def test_qsgd_zero_leaf_is_exact():
    v = torch.zeros((3, 131))
    u = torch.rand((3, 131), generator=torch.Generator().manual_seed(0))
    q, r = ops.qsgd_compress_leaf(v, u, torch.zeros(3), 15)
    assert torch.equal(q, torch.zeros_like(v))
    assert torch.equal(r, torch.zeros_like(v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qsgd_tree_matches_per_leaf_and_reference(dtype):
    """One sweep over a CNN-shaped tree stacked over 4 clients, one leaf all
    zeros: the tree call (per-row max scales folded in) equals the per-leaf
    wrapper with ``torch.amax`` scales bit for bit, and each client row
    equals the reference's Pallas kernel (interpret mode) with the
    reference's ``jnp.max`` scale at ``test_qsgd_matches_reference``'s
    bars (XLA fuses the residual where torch rounds each op: one fp32 ulp
    of a level apart)."""
    from repro_torch.core import tree as T
    from repro_torch.models.vision import cnn_init
    params = cnn_init(0, n_classes=10, width=4, image_size=16, device="cpu")
    rng = np.random.RandomState(3)
    K, s = 4, 15
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    v = T.tree_map(lambda p: as_torch(rng.randn(K, *p.shape), dtype), params)
    u = T.tree_map(lambda p: as_torch(rng.uniform(size=(K,) + tuple(p.shape)),
                                      dtype), params)
    T.leaves(v)[0].zero_()
    q, r = ops.qsgd_compress_tree(v, u, s)
    for vl, ul, ql, rl in zip(*(T.leaves(t) for t in (v, u, q, r))):
        scale = torch.amax(torch.abs(vl.reshape(K, -1)), dim=1)
        qe, re = ops.qsgd_compress_leaf(vl, ul, scale, s)
        assert ql.dtype == vl.dtype and ql.shape == vl.shape
        assert torch.equal(ql, qe) and torch.equal(rl, re)
        for k in range(K):
            j = jnp.asarray(vl[k].float().numpy(), JAX_DT[dtype])
            ju = jnp.asarray(ul[k].float().numpy(), JAX_DT[dtype])
            jq, jr = jops.qsgd_compress_leaf(j, ju, jnp.max(jnp.abs(j)), s)
            np.testing.assert_allclose(as_np(ql[k]), as_np(jq), atol=tol,
                                       rtol=tol)
            np.testing.assert_allclose(as_np(rl[k]), as_np(jr), atol=tol,
                                       rtol=tol)
    assert not T.leaves(q)[0].any() and not T.leaves(r)[0].any()


# ---------------------------------------------------------------------------
# sparse reduce
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,dtype,K,k", [
    ((64, 32), "float32", 6, 97),
    ((4096,), "bfloat16", 96, 409),
    ((17,), "float32", 3, 5),
    ((), "float32", 4, 1),
])
def test_sparse_reduce_matches_reference_bitwise(shape, dtype, K, k):
    """Random indices with many duplicates within a client: the pair order
    decides the rounding, and both sides follow it."""
    n = int(np.prod(shape)) if shape else 1
    rng = np.random.RandomState(K * 1000 + k)
    vals = rng.randn(K, k).astype(np.float32)
    idx = rng.randint(0, n, (K, k)).astype(np.int32)
    w = rng.uniform(0.2, 1.0, K).astype(np.float32)
    vt = as_torch(vals, dtype)
    got = ops.sparse_weighted_delta_reduce(vt, torch.from_numpy(idx),
                                           torch.from_numpy(w), shape,
                                           TORCH_DT[dtype])
    assert got.shape == shape and got.dtype == TORCH_DT[dtype]
    vj = jnp.asarray(vt.float().numpy(), JAX_DT[dtype])
    for fn in (jops.sparse_weighted_delta_reduce,
               jref.sparse_weighted_delta_reduce):
        want = fn(vj, jnp.asarray(idx), jnp.asarray(w), shape, JAX_DT[dtype])
        np.testing.assert_array_equal(as_np(got), as_np(want))


def test_sparse_reduce_bf16_k96_vs_fp64_oracle():
    K, N, k = 96, 4096, 409
    rng = np.random.RandomState(7)
    vals = as_torch(1.0 + 0.05 * rng.randn(K, k), "bfloat16")
    idx = np.stack([rng.choice(N, size=k, replace=False) for _ in range(K)])
    w = rng.uniform(0.2, 1.0, K).astype(np.float32)
    oracle = np.zeros(N)
    np.add.at(oracle, idx.reshape(-1),
              (w.astype(np.float64)[:, None]
               * vals.double().numpy()).reshape(-1))
    got = ops.sparse_weighted_delta_reduce(
        vals, torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(w),
        (N,), torch.float32).double().numpy()
    assert np.all(np.abs(got - oracle) <= np.abs(oracle) * 2.0 ** -8 + 1e-7)


def test_sparse_reduce_duplicate_collisions_accumulate():
    vals = torch.tensor([[1.0, 2.0, 4.0], [8.0, 16.0, 32.0]])
    idx = torch.tensor([[5, 5, 5], [5, 5, 2]], dtype=torch.int32)
    got = ops.sparse_weighted_delta_reduce(vals, idx, torch.ones(2), (8,),
                                           torch.float32)
    assert got[5] == 1 + 2 + 4 + 8 + 16 and got[2] == 32.0
    assert got[[0, 1, 3, 4, 6, 7]].sum() == 0.0


def test_sparse_reduce_empty_wire():
    out = ops.sparse_weighted_delta_reduce(
        torch.zeros((2, 0)), torch.zeros((2, 0), dtype=torch.int32),
        torch.ones(2), (8,), torch.float32)
    assert torch.equal(out, torch.zeros(8))


def test_sparse_reduce_equals_dense_decode_fold():
    """Summing the wire equals decoding each client dense and folding in
    client order, bit for bit (off-support adds are exact +0.0)."""
    K, N, k = 12, 4096, 409
    rng = np.random.RandomState(11)
    vals = torch.from_numpy(rng.randn(K, k).astype(np.float32))
    idx = torch.from_numpy(np.stack(
        [rng.choice(N, size=k, replace=False) for _ in range(K)]
    ).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.2, 1.0, K).astype(np.float32))
    dense = ops.sparse_scatter_leaf(vals, idx, (N,), torch.float32)
    acc = torch.zeros(N)
    for i in range(K):
        acc = acc + w[i] * dense[i]
    got = ops.sparse_weighted_delta_reduce(vals, idx, w, (N,), torch.float32)
    assert torch.equal(got, acc)


# ---------------------------------------------------------------------------
# the sparse top-k select (plain torch, as in the reference)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k", [(1, 1), (97, 10), (4096, 410)])
def test_topk_sparse_leaf_is_an_exact_complement(n, k):
    rows = [operand(20 + s, n, "float32") for s in range(3)]
    v = torch.stack([t for t, _ in rows])
    values, idx, residual = ops.topk_sparse_leaf(v, k)
    assert values.shape == idx.shape == (3, k) and idx.dtype == torch.int32
    dense = ops.sparse_scatter_leaf(values, idx, (n,), torch.float32)
    assert torch.equal(dense + residual, v)
    for i, (_, j) in enumerate(rows):
        jv, ji, jres = jops.topk_sparse_leaf(j, k)
        # ties may pick other indices: compare the wire as a multiset and
        # the reconstruction and residual exactly
        np.testing.assert_array_equal(np.sort(values[i].numpy()),
                                      np.sort(np.asarray(jv)))
        np.testing.assert_array_equal(residual[i].numpy(), np.asarray(jres))


# ---------------------------------------------------------------------------
# the compressors over a client-stacked tree
# ---------------------------------------------------------------------------
def tree_pair(seed, K):
    """A small CNN-shaped delta and EF tree stacked over K clients, as the
    (JAX tree of (K, ...) arrays, port tree of (K, ...) tensors) pair; the
    port keeps conv weights OIHW."""
    params = jax.eval_shape(lambda: jcnn_init(
        jax.random.PRNGKey(seed), n_classes=10, width=4, image_size=16))
    rng = np.random.RandomState(seed)

    def stacked(p):
        return jax.tree.map(
            lambda x: rng.randn(K, *x.shape).astype(np.float32), p)
    jd, je = stacked(params), stacked(params)

    def port(tree):
        def leaf(a):
            if a.ndim == 5:                        # (K, H, W, I, O)
                a = a.transpose(0, 4, 3, 1, 2)
            return torch.from_numpy(np.ascontiguousarray(a))
        return jax.tree.map(leaf, tree)
    return (jd, je), (port(jd), port(je)), params


def to_jax_layout(tree):
    def leaf(t):
        a = t.numpy()
        return a.transpose(0, 3, 4, 2, 1) if a.ndim == 5 else a
    return jax.tree.map(leaf, tree)


def test_topk_compressor_matches_reference():
    (jd, je), (td, te), _ = tree_pair(0, 4)
    q, ef = C.TopKCompressor(0.1).compress(td, te, None)
    jq, jef = jax.jit(jax.vmap(lambda d, e: JC.TopKCompressor(0.1).compress(
        d, e, None)))(jd, je)
    jax.tree.map(np.testing.assert_array_equal, to_jax_layout(q), jq)
    jax.tree.map(np.testing.assert_array_equal, to_jax_layout(ef), jef)


def jax_leaf_order(params):
    """Key paths ("c1/w") of a JAX tree in its flatten order."""
    paths, _ = jax.tree_util.tree_flatten_with_path(params)
    return ["/".join(k.key for k in path) for path, _ in paths]


def test_qsgd_compressor_with_reference_draws():
    """The reference's own draws, keyed by leaf path, go to the port: the
    two then compress the same tree to 1e-5."""
    K = 4
    (jd, je), (td, te), params = tree_pair(1, K)
    client_keys = jax.random.split(jax.random.PRNGKey(5), K)
    order = jax_leaf_order(params)
    shapes = [x.shape for x in jax.tree.leaves(params)]
    # the draws the reference's compress makes: per client, its key split
    # over the leaves in flatten order, one uniform per leaf
    per_leaf = jax.jit(jax.vmap(lambda ck: [
        jax.random.uniform(lk, shape) for lk, shape in
        zip(jax.random.split(ck, len(order)), shapes)]))(client_keys)
    by_path = {}
    for path, u in zip(order, per_leaf):
        u = np.asarray(u)
        by_path[path] = u.transpose(0, 4, 3, 1, 2) if u.ndim == 5 else u

    def source(name, shape, dtype, device):
        return torch.from_numpy(np.array(by_path[name[-1]]))

    draws = C.UniformDraws(source, ("uplink",), "cpu")
    q, ef = C.QSGDCompressor(4).compress(td, te, draws)
    jq, jef = jax.jit(jax.vmap(lambda d, e, k: JC.QSGDCompressor(4).compress(
        d, e, k)))(jd, je, client_keys)
    for got, want in ((q, jq), (ef, jef)):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, w, atol=1e-5, rtol=1e-5), to_jax_layout(got), want)


@pytest.mark.parametrize("compressor", JC.KNOWN_COMPRESSORS)
@pytest.mark.parametrize("frac,bits", [(0.1, 8), (0.013, 3), (1.0, 1)])
def test_wire_bytes_match_reference(compressor, frac, bits):
    jparams = jax.eval_shape(lambda: jcnn_init(
        jax.random.PRNGKey(0), n_classes=10, width=32, image_size=32))
    from repro_torch.models.vision import cnn_init
    tparams = cnn_init(0, n_classes=10, width=32, image_size=32, device="cpu")
    kw = dict(compressor=compressor, topk_frac=frac, qsgd_bits=bits)
    assert C.uplink_nbytes(FedConfig(**kw), tparams) == \
        JC.uplink_nbytes(JFedConfig(**kw), jparams)
    assert C.raw_nbytes(tparams) == JC.raw_nbytes(jparams)


def test_invalid_knobs_raise():
    with pytest.raises(ValueError, match="topk_frac"):
        C.TopKCompressor(0.0)
    with pytest.raises(ValueError, match="qsgd_bits"):
        C.QSGDCompressor(0)
    with pytest.raises(ValueError, match="unknown compressor"):
        C.get_compressor(FedConfig(compressor="zip"))
