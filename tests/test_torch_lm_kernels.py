"""The port's flash attention and SSD scan on the CPU, held against the JAX
package.

On the CPU the port's wrappers (``repro_torch.kernels.ops``) run the
kernels' plain versions (``repro_torch.kernels.ref``); each is compared on
the same numpy inputs with the reference's oracle (``repro.kernels.ref``)
and with its Pallas kernel in interpret mode.  Bars, from
``tests/test_kernels.py``:

* flash attention: 2e-5 (fp32) and 2e-2 (bf16) absolute and relative —
  the Pallas kernel sums its online softmax over 64-key blocks, the oracles
  over the whole row;
* the SSD scan: 2e-5 (fp32) and 5e-2 (bf16) of the output's largest
  magnitude — the sequential recurrence against the chunked kernel; the
  two sequential oracles against each other at 1e-6 (fp32, the same
  arithmetic in another library).

The CUDA kernels need the card: ``tests/test_torch_gpu.py`` holds them
against these plain versions there and skips here.  What can be checked
here of them is checked here: the bf16 kernel's rounding, emulated in
torch, against the Pallas kernel; and the refusal of a gradient that the
card's route cannot give.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as JSSD
from repro.models import mamba2 as jM2
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import mamba2 as M2

DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def operand(rng, shape, dtype):
    """One numpy-made operand as (torch, jax), representable in dtype."""
    t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        DT[dtype][0])
    return t, jnp.asarray(t.float().numpy(), DT[dtype][1])


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_SHAPES = [(1, 2, 2, 128, 64),     # MHA
                (2, 4, 2, 256, 64),     # GQA group 2
                (1, 8, 1, 128, 128),    # MQA
                (1, 4, 4, 192, 64)]     # L not a multiple of the block


@pytest.mark.parametrize("B,H,Hk,L,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference(B, H, Hk, L, D, dtype):
    rng = np.random.RandomState(L + H)
    (q, jq), (k, jk), (v, jv) = (operand(rng, s, dtype) for s in (
        (B, H, L, D), (B, Hk, L, D), (B, Hk, L, D)))
    got = ref.flash_attention(q, k, v, causal=True)
    assert got.dtype == DT[dtype][0]
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jref.flash_attention(jq, jk, jv, causal=True),
                 JFA.flash_attention(jq, jk, jv, causal=True, block_q=64,
                                     block_k=64, interpret=True)):
        np.testing.assert_allclose(f32(got), f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [32, 64, 128])
def test_flash_plain_window_matches_reference(window):
    rng = np.random.RandomState(window)
    (q, jq), (k, jk), (v, jv) = (operand(rng, (1, 2, 256, 64), "float32")
                                 for _ in range(3))
    got = ref.flash_attention(q, k, v, causal=True, window=window)
    for want in (jref.flash_attention(jq, jk, jv, causal=True, window=window),
                 JFA.flash_attention(jq, jk, jv, causal=True, window=window,
                                     block_q=64, block_k=64, interpret=True)):
        np.testing.assert_allclose(f32(got), f32(want), atol=2e-5, rtol=2e-5)


def test_flash_ops_keeps_the_model_layout():
    """ops.flash_attention takes and gives (B, L, H, D), as the reference's
    ops wrapper does, and equals its Pallas route."""
    rng = np.random.RandomState(2)
    (q, jq), (k, jk), (v, jv) = (operand(rng, s, "float32") for s in (
        (2, 128, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64)))
    got = ops.flash_attention(q, k, v, causal=True)
    assert tuple(got.shape) == (2, 128, 4, 64)
    np.testing.assert_allclose(f32(got), f32(jops.flash_attention(jq, jk, jv)),
                               atol=3e-5, rtol=3e-5)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
SSD_SHAPES = [(1, 64, 2, 16, 8, 16),
              (2, 128, 4, 32, 16, 32),
              (1, 256, 2, 64, 64, 64),     # zamba2's state size
              (2, 96, 3, 16, 8, 32)]       # L not a multiple of 2 chunks


def ssd_operands(seed, b, L, H, P, N, dtype):
    rng = np.random.RandomState(seed)
    x, jx = operand(rng, (b, L, H, P), dtype)
    dt_np = np.log1p(np.exp(rng.randn(b, L, H))).astype(np.float32)
    dt, jdt = torch.from_numpy(dt_np), jnp.asarray(dt_np)
    A_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32))
    B, jB = operand(rng, (b, L, H, N), dtype)
    C, jC = operand(rng, (b, L, H, N), dtype)
    D = torch.ones(H)
    j = (jx, jdt, jnp.asarray(A_log.numpy()), jB, jC, jnp.ones((H,)))
    return (x, dt, A_log, B, C, D), j


def assert_rel(got, want, tol):
    want = f32(want)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(f32(got) / scale, want / scale, atol=tol,
                               rtol=0)


@pytest.mark.parametrize("b,L,H,P,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_plain_matches_reference(b, L, H, P, N, chunk, dtype):
    args, jargs = ssd_operands(L + P, b, L, H, P, N, dtype)
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    seq = ref.ssd_scan(*args)
    assert_rel(seq, jref.ssd_scan(*jargs), 1e-6)
    pallas = JSSD.ssd_scan(*jargs, chunk=chunk, interpret=True)
    assert_rel(seq, pallas, tol)
    # the kernel route: the output rounded to x's dtype before the D term
    got = ops.ssd_scan(*args, chunk=chunk)
    assert got.dtype == torch.float32
    assert_rel(got, pallas, tol)


@pytest.mark.parametrize("L,chunk", [(100, 32), (300, 256)])
def test_ssd_ragged_length(L, chunk):
    """A length that is not a multiple of the chunk, against the
    reference's sequential oracle.  (The Pallas kernel's cdiv grid reads
    past L in the last chunk; in interpret mode those reads are NaN, which
    reach the valid rows through the causally masked product, 0·NaN, so
    it is no yardstick here.)"""
    args, jargs = ssd_operands(L, 1, L, 2, 32, 16, "float32")
    assert_rel(ops.ssd_scan(*args, chunk=chunk), jref.ssd_scan(*jargs), 2e-5)


def test_ssd_chunked_matches_reference():
    """The model's einsum route (``use_pallas=False``) against the
    reference's (2e-5 of the largest magnitude: XLA contracts the
    three-operand einsums in another order), and against the kernel route
    (same math, the reference's bar for it)."""
    args, jargs = ssd_operands(4, 2, 128, 4, 32, 16, "float32")
    got = M2.ssd_chunked(*args, chunk=32)
    assert_rel(got, jM2.ssd_chunked(*jargs, chunk=32), 2e-5)
    np.testing.assert_allclose(f32(got), f32(ops.ssd_scan(*args, chunk=32)),
                               atol=3e-4, rtol=1e-3)


# the CUDA kernel's three phases (chunk states, carry, outputs), plainly
def ssd_phases(x, dt, A_log, B, C, D, chunk):
    """``ref``'s phase functions composed, the D skip added as ops does."""
    xdt, a = ref.ssd_prologue(x, dt, A_log)
    y = ref.ssd_chunked_scan(xdt, a, B, C, min(chunk, x.shape[1]))
    return y + D.float()[None, None, :, None] * xdt


@pytest.mark.parametrize("b,L,H,P,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_phases_match_reference(b, L, H, P, N, chunk, dtype):
    """The kernel's phases composed against the reference's sequential
    oracle and its Pallas kernel (interpret mode), at the reference's
    bars."""
    args, jargs = ssd_operands(L + P + 1, b, L, H, P, N, dtype)
    tol = 5e-2 if dtype == "bfloat16" else 2e-5
    got = ssd_phases(*args, chunk)
    assert_rel(got, jref.ssd_scan(*jargs), tol)
    assert_rel(got, JSSD.ssd_scan(*jargs, chunk=chunk, interpret=True), tol)


@pytest.mark.parametrize("L,chunk", [(100, 32), (300, 256), (1100, 256),
                                     (50, 256)])
def test_ssd_phases_ragged_length(L, chunk):
    """A ragged last chunk, and L shorter than one chunk, against the
    sequential oracle only (the Pallas kernel reads NaN past L in interpret
    mode): the padded positions change neither y nor the carried state."""
    args, jargs = ssd_operands(L + 7, 1, L, 2, 32, 16, "float32")
    assert_rel(ssd_phases(*args, chunk), jref.ssd_scan(*jargs), 2e-5)


def test_ssd_phase_intermediates():
    """What the kernels leave in device memory, plainly: acum is the
    running sum of a within each chunk (flat past L), and the state before
    chunk c is the sequential recurrence's state after c·chunk positions."""
    b, L, H, P, N, chunk = 2, 200, 3, 16, 8, 64
    args, _ = ssd_operands(11, b, L, H, P, N, "float32")
    xdt, a = ref.ssd_prologue(*args[:3])
    acum, S = ref.ssd_chunk_states(xdt, a, args[3], chunk)
    h_prev = ref.ssd_state_pass(S, acum)
    assert acum.dtype == torch.float64 and acum.shape == (b, H, 4, chunk)
    assert S.shape == h_prev.shape == (b, H, 4, N, P)
    a64 = torch.nn.functional.pad(a.double(), (0, 0, 0, 4 * chunk - L))
    want = torch.cumsum(a64.reshape(b, 4, chunk, H), dim=2).permute(0, 3, 1, 2)
    torch.testing.assert_close(acum, want, rtol=0, atol=1e-12)
    assert torch.equal(acum[..., 3, L - 3 * chunk - 1:],
                       acum[..., 3, L - 3 * chunk - 1:L - 3 * chunk].expand(
                           -1, -1, 4 * chunk - L + 1))
    assert not h_prev[:, :, 0].any()
    h = torch.zeros((b, H, N, P), dtype=torch.float64)
    decay = torch.exp(a.double())
    for t in range(3 * chunk):
        if t % chunk == 0:
            got = h_prev[:, :, t // chunk].double()
            assert ((got - h).abs().max() / h.abs().max().clamp_min(1e-30)
                    <= 1e-5)
        h = (h * decay[:, t, :, None, None] + args[3][:, t, :, :, None]
             .double() * xdt[:, t, :, None, :].double())


def test_ssd_phases_underflowing_decays_stay_finite():
    """Decays of e^(-1e4) and beyond within a chunk (the gates underflow to
    0): no NaN, and the sequential oracle's result."""
    args, jargs = ssd_operands(5, 1, 512, 2, 16, 8, "float32")
    x, dt, _, B, C, D = args
    dt = dt * 40.0
    A_log = torch.log(torch.tensor([20.0, 200.0]))
    got = ssd_phases(x, dt, A_log, B, C, D, 256)
    assert torch.isfinite(got).all()
    assert_rel(got, ref.ssd_scan(x, dt, A_log, B, C, D), 2e-5)


def bf16_ssd_emulation(xdt, a, B, C, chunk):
    """The bf16 kernel's roundings in torch: the products C·Bᵀ exact in
    fp32 from bf16 operands, the gated scores P and x·dt each split into a
    bf16 part and its bf16-rounded remainder, P·x = P_hi·x_hi + P_hi·x_lo +
    P_lo·x_hi; the state's w·x and the carried state likewise."""
    def split(t):
        hi = t.to(torch.bfloat16).float()
        return hi, (t - hi).to(torch.bfloat16).float()

    def split_prod(p, q, eq):
        ph, pl = split(p)
        qh, ql = split(q)
        return (torch.einsum(eq, ph, qh) + torch.einsum(eq, ph, ql)
                + torch.einsum(eq, pl, qh))
    L = xdt.shape[1]
    acum, _ = ref.ssd_chunk_states(xdt, a, B, chunk)
    Bc, Cc = ref._chunked(B, chunk), ref._chunked(C, chunk)
    xc = ref._chunked(xdt, chunk)
    w = torch.exp((acum[..., -1:] - acum).float())
    wx = xc * w.permute(0, 2, 3, 1)[..., None]
    S = torch.einsum("bcqhn,bcqhp->bhcnp", Bc, split(wx)[0]) + torch.einsum(
        "bcqhn,bcqhp->bhcnp", Bc, split(wx)[1])
    h_prev = ref.ssd_state_pass(S, acum)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    diff = (acum[..., :, None] - acum[..., None, :]).float()
    gate = torch.exp(torch.where(causal, diff, torch.zeros_like(diff)))
    scores = torch.einsum("bcqhn,bckhn->bhcqk", Cc, Bc)
    P = torch.where(causal, scores * gate, torch.zeros_like(scores))
    y = split_prod(P, xc, "bhcqk,bckhp->bcqhp")
    hh, hl = split(h_prev)
    carried = (torch.einsum("bcqhn,bhcnp->bcqhp", Cc, hh)
               + torch.einsum("bcqhn,bhcnp->bcqhp", Cc, hl))
    y = y + carried * torch.exp(acum).float().permute(0, 2, 3, 1)[..., None]
    return y.reshape((y.shape[0], -1) + y.shape[3:])[:, :L]


@pytest.mark.parametrize("b,L,H,P,N,chunk", SSD_SHAPES)
def test_ssd_bf16_kernel_rounding_meets_the_reference_bar(b, L, H, P, N,
                                                          chunk):
    """The bf16 route's rounding, emulated, against the reference's Pallas
    kernel at its bf16 bar (5e-2 of max |y|) and, much tighter, against the
    phases in fp32 (the split keeps the products near fp32: 1e-4)."""
    args, jargs = ssd_operands(L + N, b, L, H, P, N, "bfloat16")
    x, dt, A_log, B, C, D = args
    xdt, a = ref.ssd_prologue(x, dt, A_log)
    y = bf16_ssd_emulation(xdt, a, B, C, chunk)
    assert_rel(y, ref.ssd_chunked_scan(xdt, a, B, C, chunk), 1e-4)
    got = y.to(torch.bfloat16).float() + D[None, None, :, None] * xdt
    assert_rel(got, JSSD.ssd_scan(*jargs, chunk=chunk, interpret=True), 5e-2)


# ---------------------------------------------------------------------------
# the wrappers on the CPU
# ---------------------------------------------------------------------------
def test_cpu_route_counts_no_launch_and_kernels_refuse_cpu_tensors():
    ops.reset_launch_counts()
    args, _ = ssd_operands(0, 1, 64, 2, 16, 8, "float32")
    ops.ssd_scan(*args, chunk=16)
    q = torch.randn(1, 64, 2, 64)
    ops.flash_attention(q, q, q)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["ssd_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention(q, q, q)
    xdt, a = ref.ssd_prologue(*args[:3])
    with pytest.raises(ValueError, match="CUDA"):
        SSD.ssd_scan(xdt, a, args[3], args[4], 16, torch.float32)


# ---------------------------------------------------------------------------
# no backward on the card: the refusal
# ---------------------------------------------------------------------------
def test_refuse_grad_raises_only_where_a_gradient_is_needed():
    x = torch.randn(3, requires_grad=True)
    y = torch.randn(3)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        ops._refuse_grad("flash_attention", y, x)
    with pytest.raises(RuntimeError, match="ssd_scan.*no backward"):
        ops._refuse_grad("ssd_scan", x)
    ops._refuse_grad("flash_attention", y, y)
    with torch.no_grad():
        ops._refuse_grad("ssd_scan", x, y)


def test_cpu_route_still_differentiates():
    """The CPU route runs the plain versions, which autograd
    differentiates: the parity tests of the models' gradients rely on
    them."""
    q = torch.randn(1, 64, 2, 64, requires_grad=True)
    ops.flash_attention(q, q, q).square().sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    assert q.grad.abs().sum() > 0
    args, _ = ssd_operands(1, 1, 64, 2, 16, 8, "float32")
    x = args[0].clone().requires_grad_()
    ops.ssd_scan(x, *args[1:], chunk=16).square().sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    assert x.grad.abs().sum() > 0


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic, emulated
# ---------------------------------------------------------------------------
def bf16_kernel_emulation(q, k, v, causal=True, window=0):
    """q (B, H, L, D), k/v (B, Hk, L, D) bf16 -> (B, H, L, D) bf16 by the
    tensor-core kernel's arithmetic: exact bf16 products summed in fp32;
    the fp32 scores scaled with log2(e) folded in; an online softmax over
    key tiles of 128 keys (D 64) or 64 (D 128), with the running max in
    raw score units and fp32 sums of the unrounded p; P rounded to bf16
    before P·V, accumulated in fp32; one division and one rounding at the
    end."""
    B, H, L, D = q.shape
    g = H // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    sl2 = D ** -0.5 * math.log2(math.e)
    bk = 128 if D == 64 else 64
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf)
    qpos = torch.arange(L)[:, None]
    m = torch.full((B, H, L, 1), -math.inf)
    l = torch.zeros((B, H, L, 1))
    acc = torch.zeros((B, H, L, D))
    for k0 in range(0, L, bk):
        s = scores[..., k0:k0 + bk]
        kpos = torch.arange(k0, min(k0 + bk, L))[None, :]
        vis = torch.ones((L, kpos.shape[1]), dtype=torch.bool)
        if causal:
            vis &= kpos <= qpos
        if window > 0:
            vis &= kpos > qpos - window
        s = torch.where(vis, s, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        ms = torch.where(m_new == -math.inf, 0.0, m_new * sl2)
        corr = torch.exp2(m * sl2 - ms)
        p = torch.exp2(s * sl2 - ms)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + p.bfloat16().float() @ vf[..., k0:k0 + bk, :]
        m = m_new
    return (acc / l.clamp_min(1e-30)).bfloat16()


@pytest.mark.parametrize("B,H,Hk,L,D,window",
                         [shape + (0,) for shape in FLASH_SHAPES]
                         + [(1, 2, 2, 256, 64, w) for w in (32, 64, 128)])
def test_bf16_kernel_rounding_meets_the_reference_bar(B, H, Hk, L, D,
                                                      window):
    """The bf16 kernel's design (P rounded to bf16, the scale on the fp32
    scores, exp2 with log2(e) folded in) stays within the reference's bf16
    bar, 2e-2 abs + rel, of the Pallas kernel in interpret mode at the
    reference sweep's shapes: MHA, GQA, MQA at D 128, a ragged L 192 and
    the windows."""
    rng = np.random.RandomState(L + H + window)
    (q, jq), (k, jk), (v, jv) = (operand(rng, s, "bfloat16") for s in (
        (B, H, L, D), (B, Hk, L, D), (B, Hk, L, D)))
    got = bf16_kernel_emulation(q, k, v, causal=True, window=window)
    want = JFA.flash_attention(jq, jk, jv, causal=True, window=window,
                               block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(f32(got), f32(want), atol=2e-2, rtol=2e-2)
