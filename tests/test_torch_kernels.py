"""The port's four update kernels, held against the JAX package (the
three wire kernels are in ``test_torch_compression.py``, the KD loss in
``test_torch_distillation.py``).

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the plain
PyTorch versions; each is compared with the reference's Pallas kernel in
interpret mode (``repro.kernels.ops``) and with its jnp oracle
(``repro.kernels.ref``) on the same numpy inputs.  Bars:

* fp32: 1e-6 of the magnitude of the terms (|x| + |a·y| for an axpy,
  Σ_k |w_k·Δ_k| for the reduce): both sides round each op in fp32, but XLA
  may contract or reorder where the port does not;
* bf16: one bf16 ulp of the larger of result and terms.  The port computes
  in fp32 and rounds once on write; the reference rounds each bf16 op;
* the weighted reduce at bf16, K=96, against an fp64 oracle at
  rtol = 2**-8, as ``test_kernels.py`` holds the reference.

The CUDA kernels themselves need the card: ``tests/test_torch_gpu.py``
holds each against its plain version there (bit for bit) and skips here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import compress as CP
from repro_torch.kernels import fedadc_update as FU
from repro_torch.kernels import kd_loss as KD
from repro_torch.kernels import ops
from repro_torch.kernels import sparse_reduce as SR
from repro_torch.kernels import weighted_reduce as WR

LENGTHS = [1, 10, 130, 1290]
DTYPES = ["float32", "bfloat16"]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def operands(seed, n, count, dtype):
    """`count` arrays of length n, representable in `dtype`, as (numpy f32,
    torch, jax) triples."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        a = rng.randn(n).astype(np.float32)
        t = torch.from_numpy(a).to(TORCH_DT[dtype])
        out.append((t.float().numpy(), t, jnp.asarray(a, JAX_DT[dtype])))
    return out


def f64(x):
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x.astype(jnp.float32), np.float64)


def bf16_ulp(v):
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def assert_close(got, want, terms, dtype):
    got, want = f64(got), f64(want)
    if dtype == "float32":
        bound = 1e-6 * terms
    else:
        bound = bf16_ulp(np.maximum(np.abs(want), terms))
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_axpy(n, dtype):
    (xn, xt, xj), (yn, yt, yj) = operands(0, n, 2, dtype)
    a = -0.05
    got = ops.fused_axpy(xt, yt, a)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (n,)
    terms = np.abs(xn) + np.abs(a * yn)
    assert_close(got, jops.fused_axpy(xj, yj, a), terms, dtype)
    assert_close(got, jref.fused_axpy(xj, yj, a), terms, dtype)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_local_update(n, dtype):
    (tn, tt, tj), (gn, gt, gj), (mn, mt, mj) = operands(1, n, 3, dtype)
    eta = 0.05
    got = ops.fedadc_local_update(tt, gt, mt, eta)
    terms = np.abs(tn) + eta * (np.abs(gn) + np.abs(mn))
    want = jops.fedadc_local_update({"p": tj}, {"p": gj}, {"p": mj}, eta)
    assert_close(got, want["p"], terms, dtype)
    assert_close(got, jref.fedadc_local_update(tj, gj, mj, eta), terms, dtype)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_server_update(n, dtype):
    """θ in `dtype`; m and Δ̄ fp32 in the port.  The inputs are
    bf16-representable, so the reference's Pallas wrapper, which casts m
    and Δ̄ to θ's dtype, sees the same values."""
    (tn, tt, tj), (mn, mt, _), (dn, dt_, _) = operands(2, n, 3, dtype)
    gamma, alpha_eta = 0.2, 0.05
    m32, d32 = mt.float(), dt_.float()
    got_t, got_m = ops.fedadc_server_update(tt, m32, d32, gamma, alpha_eta)
    assert got_t.dtype == TORCH_DT[dtype] and got_m.dtype == torch.float32
    mj, dj = jnp.asarray(mn), jnp.asarray(dn)
    m_terms = np.abs(dn) + gamma * np.abs(mn)
    t_terms = np.abs(tn) + alpha_eta * m_terms
    ref_t, ref_m = jref.fedadc_server_update(tj, mj, dj, gamma, alpha_eta)
    # the fp32 momentum is compared at the fp32 bar whatever θ's dtype
    assert_close(got_m, ref_m, m_terms, "float32")
    assert_close(got_t, ref_t.astype(JAX_DT[dtype]), t_terms, dtype)
    pal_t, pal_m = jops.fedadc_server_update({"p": tj}, {"p": mj.astype(tj.dtype)},
                                             {"p": dj.astype(tj.dtype)},
                                             gamma, alpha_eta)
    assert_close(got_t, pal_t["p"], t_terms, dtype)
    assert_close(got_m, pal_m["p"], m_terms, dtype)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 8])
def test_weighted_reduce(n, dtype, k):
    rng = np.random.RandomState(3)
    d = rng.randn(k, n).astype(np.float32)
    w = rng.uniform(0.2, 1.0, k).astype(np.float32)
    dt = torch.from_numpy(d).to(TORCH_DT[dtype])
    got = ops.weighted_delta_reduce(dt, torch.from_numpy(w))
    assert got.dtype == TORCH_DT[dtype] and got.shape == (n,)
    dn = dt.float().numpy()
    terms = np.sum(np.abs(w[:, None] * dn), axis=0)
    dj, wj = jnp.asarray(dn, JAX_DT[dtype]), jnp.asarray(w)
    assert_close(got, jops.weighted_delta_reduce({"x": dj}, wj)["x"], terms,
                 dtype)
    assert_close(got, jref.weighted_delta_reduce(dj, wj), terms, dtype)


def test_weighted_reduce_bf16_k96_matches_fp64_oracle():
    """fp32 accumulation + one final bf16 rounding: within 1 bf16 ulp of the
    fp64 oracle, on the reference test's adversarial operands (positive
    values ~1.0, so the partial sum grows monotonically)."""
    K, N = 96, 4096
    rng = np.random.RandomState(7)
    d64 = 1.0 + 0.05 * rng.randn(K, N)
    d_bf16 = torch.from_numpy(d64).to(torch.bfloat16)
    w = torch.from_numpy(rng.uniform(0.2, 1.0, K).astype(np.float32))
    oracle = np.tensordot(w.double().numpy(), d_bf16.double().numpy(),
                          axes=([0], [0]))
    got = ops.weighted_delta_reduce(d_bf16, w).double().numpy()
    assert np.all(np.abs(got - oracle) <= np.abs(oracle) * 2.0 ** -8)
    pal = np.asarray(jops.weighted_delta_reduce(
        {"x": jnp.asarray(d64, jnp.bfloat16)},
        jnp.asarray(w.numpy()))["x"], np.float64)
    np.testing.assert_allclose(got, pal, rtol=2.0 ** -8, atol=0)


def test_cpu_runs_plain_versions_and_counts_no_launch():
    """A CPU tensor takes the plain version: the launch counters stay 0, and
    the kernels' own wrappers refuse CPU tensors instead of computing."""
    ops.reset_launch_counts()
    x = torch.randn(100)
    ops.fused_axpy(x, x, 0.5)
    ops.fedadc_local_update(x, x, x, 0.5)
    ops.fedadc_server_update(x, x, x, 0.2, 0.5)
    ops.weighted_delta_reduce(torch.stack([x, x]), torch.ones(2))
    rows = torch.stack([x, x])
    ops.topk_compress_leaf(rows, torch.ones(2))
    ops.qsgd_compress_leaf(rows, torch.rand(2, 100), torch.ones(2), 15)
    ops.sparse_weighted_delta_reduce(rows, torch.zeros((2, 100),
                                                       dtype=torch.int32),
                                     torch.ones(2), (100,), torch.float32)
    labels = torch.zeros(2, dtype=torch.int64)
    logits = rows.clone().requires_grad_()
    ops.kd_loss(logits, rows, labels, torch.ones(100), 0.35, 1.0)[0].sum(
        ).backward()
    q = torch.randn(1, 8, 2, 64)
    ops.flash_attention(q, q, q)
    ops.ssd_scan(q, torch.rand(1, 8, 2), torch.zeros(2), q, q, torch.ones(2),
                 4)
    assert ops.launch_counts() == {"fused_axpy": 0, "local_update": 0,
                                   "server_update": 0, "weighted_reduce": 0,
                                   "threshold_select": 0, "qsgd": 0,
                                   "sparse_reduce": 0, "kd_loss": 0,
                                   "kd_loss_bwd": 0, "flash_attention": 0,
                                   "ssd_scan": 0}
    with pytest.raises(ValueError, match="CUDA"):
        FU.fused_axpy(x, x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        FU.local_update(x, x, x, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        FU.server_update(x, x, x, 0.2, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        WR.weighted_reduce(torch.stack([x, x]), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        CP.threshold_select(rows, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        CP.qsgd(rows, rows, torch.ones(2), 15)
    with pytest.raises(ValueError, match="CUDA"):
        SR.sparse_reduce(rows, torch.zeros((2, 100), dtype=torch.int32),
                         torch.ones(2), (100,), torch.float32)
    rho = torch.ones(1, 100)
    with pytest.raises(ValueError, match="CUDA"):
        KD.kd_loss(rows, rows, labels, rho, 0.35, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        KD.kd_loss_bwd(rows, rows, labels, rho, torch.zeros(2, 5),
                       torch.ones(2), 0.35, 1.0)
