"""Every operand shape that the reference's Pallas kernels take, on the
port's side: the flash attention, SSD scan, KD forward and sparse reduce
wrappers plan each one and refuse none but the int32 bounds.

Each wrapper's route plan is a pure function of shapes
(``flash_attention.plan``, ``ssd_scan.plan``, ``kd_loss.fwd_plan`` /
``bwd_plan``, ``sparse_reduce.segments`` / ``_plan``), so the tests below
show on the CPU that every shape of the card's checks is planned and that
the plan covers it exactly.  The kernels themselves run only on the card
(``chip_smoke.py``, ``--kernel-shapes``); here the plain versions
(``repro_torch.kernels.ref``) are held against the JAX package at reduced
sizes of the same shape classes, at the reference's bars
(``tests/test_kernels.py``), and each route's decomposition (the KD
forward's split rows, the SSD's slices and passes, the sparse reduce's
segments, flash's zero-padded head dims) is emulated plainly and held to
the undivided result.
"""
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.kernels import ref as jref
from repro.kernels import ssd_scan as JSSD
from repro.models import transformer as jT
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.core import tree as T
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import kd_loss as KD
from repro_torch.kernels import ref
from repro_torch.kernels import sparse_reduce as SR
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import transformer as PT
from repro_torch.models.registry import get_model
from test_torch_lm import assert_rel, jcfg, np_tree

# the card's shapes (chip_smoke.py): flash (B, H, Hk, L, D, window), SSD
# (b, L, H, P, N, chunk), KD (rows, C, groups), sparse leaves (elements,
# top-k fraction)
FLASH_SHAPES = [(1, 32, 32, 2048, 80, 0), (1, 32, 32, 4096, 96, 0),
                (1, 16, 16, 4096, 256, 0), (1, 8, 2, 1024, 256, 256),
                (2, 4, 2, 192, 40, 0), (1, 4, 4, 256, 320, 0),
                (1, 2, 1, 128, 512, 0)]
SSD_SHAPES = [(1, 4096, 80, 64, 128, 256), (2, 1100, 4, 128, 128, 256),
              (1, 512, 2, 160, 192, 128), (1, 2048, 4, 64, 64, 512),
              (1, 1000, 2, 32, 16, 1000), (1, 1024, 4, 64, 128, 256),
              (4, 2048, 64, 64, 64, 256)]
KD_SHAPES = [(16, KD.max_classes(4), 2, 4), (16, KD.max_classes(4) + 1, 2, 4),
             (16, KD.max_classes(2), 2, 2), (16, KD.max_classes(2) + 1, 2, 2),
             (64, 256000, 4, 4), (64, 256000, 4, 2), (8, 600000, 1, 2)]
SPARSE_LEAVES = [(3350 * 8192 + 1, 0.1), (65536000, 0.1), (2 ** 30 + 3, 0.01)]
K_CLIENTS = 4


# ---------------------------------------------------------------------------
# the plans: every shape accepted, and covered exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plan_covers_the_head_dim(shape, dtype):
    D = shape[4]
    pl = FA.plan(D, dtype)
    assert pl["d_pad"] >= D and pl["d_pad"] % 8 == 0
    assert pl["d_pad"] - D < 8
    if pl["route"] == "tc":           # a k16 step of Q·Kᵀ, at most 256
        assert dtype == torch.bfloat16
        assert pl["template"] % 16 == 0 and pl["d_pad"] <= pl["template"]
        assert pl["template"] in FA.TC_TEMPLATES
    elif pl["route"] == "f32":        # the CUDA cores' 64-column groups
        assert dtype == torch.float32
        assert pl["template"] % 64 == 0 and pl["d_pad"] <= pl["template"]
    else:
        assert D > (256 if dtype == torch.bfloat16 else 128)
        assert all(t % 64 == 0 and w <= t <= FA.WIDE_SLICE
                   for t, (_, w) in zip(pl["template"], pl["slices"]))
    # the slices of V's columns tile [0, d_pad), a launch each
    edges = [0] + [v0 + w for v0, w in pl["slices"]]
    assert [v0 for v0, _ in pl["slices"]] == edges[:-1]
    assert edges[-1] == pl["d_pad"] and pl["launches"] == len(pl["slices"])


def test_flash_plan_takes_every_head_dim():
    """D 1 to 600 in both dtypes: a route each, none refused; the bf16
    templates hold D 32, 80, 96, 192 and 256 as they are."""
    for dtype in (torch.float32, torch.bfloat16):
        for D in range(1, 601):
            pl = FA.plan(D, dtype)
            assert pl["d_pad"] >= D and pl["launches"] >= 1
    for D in (32, 64, 80, 96, 128, 192, 256):
        assert FA.plan(D, torch.bfloat16)["template"] == D
    with pytest.raises(ValueError, match="at least 1"):
        FA.plan(0, torch.float32)


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_plan_covers_every_axis(shape):
    b, L, H, P, N, chunk = shape
    pl = SSD.plan(*shape)
    for slices, n in ((pl["n_slices"], N), (pl["p_slices"], P)):
        edges = [0] + [s0 + w for s0, w in slices]
        assert [s0 for s0, _ in slices] == edges[:-1] and edges[-1] == n
        assert all(0 < w <= SSD.TILE for _, w in slices)
    edges = [0] + [n0 + w for n0, w, _ in pl["passes"]]
    assert [n0 for n0, _, _ in pl["passes"]] == edges[:-1] and edges[-1] == N
    assert all(w <= t <= SSD.MAX_NT and t % SSD.TILE == 0
               for _, w, t in pl["passes"])
    assert pl["n_pad"] == len(pl["n_slices"]) * SSD.TILE >= N
    assert pl["p_pad"] == len(pl["p_slices"]) * SSD.TILE >= P
    assert pl["q_pad"] % SSD.TILE == 0 and chunk <= pl["q_pad"] < chunk + 64
    assert pl["n_chunks"] == math.ceil(L / chunk)
    assert pl["long_chunk"] == (chunk > SSD.MAX_Q)
    assert (pl["grids"]["sums"] > 0) == pl["long_chunk"]
    assert pl["part"] == (b * L * H * P if N > SSD.MAX_NT else 0)
    assert pl["launches"] == 1
    # N up to 128 natively: one pass
    assert (len(pl["passes"]) == 1) == (N <= SSD.MAX_NT)


def test_ssd_plan_refuses_only_what_no_kernel_takes():
    with pytest.raises(ValueError, match="at least 1"):
        SSD.plan(1, 64, 2, 16, 0, 16)
    with pytest.raises(ValueError, match="int32"):
        SSD.plan(2 ** 20, 2 ** 20, 64, 64, 64, 64)
    # P, N and the chunk have no cap of their own
    assert len(SSD.plan(1, 64, 1, 1000, 1000, 4096)["passes"]) == 8


@pytest.mark.parametrize("rows,C,groups,esize", KD_SHAPES)
def test_kd_plans_cover_the_row(rows, C, groups, esize):
    route, ctas, slice_, scratch = KD.fwd_plan(rows, C, esize)
    assert route == ("cluster" if C <= KD.max_classes(esize) else "split")
    assert (ctas - 1) * slice_ < C <= ctas * slice_
    if route == "split":
        assert slice_ == KD.SPLIT_SLICE
        assert scratch == rows * (9 * ctas + 6)
    else:
        assert ctas <= KD.MAX_CLUSTER and scratch == 0
    tiles, per, wide = KD.bwd_plan(rows, C)     # the backward: any C
    assert wide and tiles == rows * per
    assert (per - 1) * KD.BWD_TILE < C <= per * KD.BWD_TILE


def test_kd_forward_takes_every_class_count():
    for esize in (4, 2):
        routes = {KD.fwd_plan(8, C, esize)[0]
                  for C in (1, 1024, 1025, KD.max_classes(esize),
                            KD.max_classes(esize) + 1, 10 ** 6, 2 ** 27)}
        assert routes == {"warp", "cluster", "split"}


@pytest.mark.parametrize("n,frac", SPARSE_LEAVES)
def test_sparse_segments_tile_the_leaf(n, frac):
    segs = SR.segments(n)
    assert len(segs) > 1                 # wider than one scatter's tiles
    edges = [0] + [b + w for b, w in segs]
    assert [b for b, _ in segs] == edges[:-1] and edges[-1] == n
    assert all(0 < w <= SR.MAX_TILES * SR.TILE for _, w in segs)
    k = max(1, math.ceil(frac * n))
    for esize in (4, 2):
        rows, total, views, scratch, owner = SR._plan([(n,)], [k],
                                                      K_CLIENTS, esize)
        assert len(rows) == len(segs) and list(owner) == [0] * len(segs)
        # fields: out byte offset, n, k, base; then tile, chunk, matrix and
        # bin ends (the leaf's K·k bins reserved once)
        assert list(rows[:, 2]) == [b * esize for b, _ in segs]
        assert list(rows[:, 3]) == [w for _, w in segs]
        assert list(rows[:, 5]) == [b for b, _ in segs]
        tiles = [-(-w // SR.TILE) for _, w in segs]
        assert list(rows[:, 6]) == list(np.cumsum(tiles))
        chunks = -(-K_CLIENTS * k // SR.CHUNK)
        assert list(rows[:, 8]) == list(np.cumsum([t * chunks for t in tiles]))
        assert list(rows[:, 9]) == [K_CLIENTS * k] * len(segs)
        assert total >= n and views == [((n,), (1,), 0)]
        # the count matrix above WIDE_SCAN entries: its rounds' sums and
        # their scan after the bins
        mat = rows[-1, 8]
        assert mat > SR.WIDE_SCAN
        assert scratch[3] - scratch[2] == 2 * -(-mat // SR.SCAN_ROUND) + 1


def test_sparse_plan_over_zamba2_leaves():
    """zamba2-1.2b's 74 leaves at K 4 x top-k 10%: planned, its embedding
    (65,536,000 elements) in three segments; groups of 64 rows each reserve
    under 2**31 bins."""
    cfg = get_arch("zamba2-1.2b")
    shapes = [tuple(x.shape) for x in T.leaves(
        get_model(cfg).init(0, cfg, device="meta"))]
    assert len(shapes) == 74 and (cfg.vocab_size, cfg.d_model) in shapes
    ks = [max(1, math.ceil(0.1 * math.prod(s))) for s in shapes]
    rows, total, views, scratch, owner = SR._plan(shapes, ks, K_CLIENTS, 4)
    assert len(rows) == sum(len(SR.segments(math.prod(s))) for s in shapes)
    assert sorted(set(owner)) == list(range(74))
    assert [v[0] for v in views] == shapes
    for g in range(0, len(rows), 64):
        group = rows[g:g + 64]
        assert group[-1, 9] < 2 ** 31


def test_sparse_plan_refuses_only_the_int32_bounds():
    with pytest.raises(ValueError, match="int32"):
        SR._plan([(2 ** 31,)], [1], K_CLIENTS, 4)
    with pytest.raises(ValueError, match="int32"):
        SR._plan([(2 ** 30,)], [2 ** 29], K_CLIENTS, 4)
    SR._plan([(2 ** 31 - 1,)], [1], K_CLIENTS, 4)


# ---------------------------------------------------------------------------
# the plain versions against the reference, and each route's decomposition
# ---------------------------------------------------------------------------
def qkv(rng, B, H, Hk, L, D, dtype=torch.float32):
    shapes = ((B, H, L, D), (B, Hk, L, D), (B, Hk, L, D))
    t = [torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dtype)
         for s in shapes]
    return t, [jnp.asarray(x.float().numpy(), jnp.bfloat16
                           if dtype == torch.bfloat16 else jnp.float32)
               for x in t]


@pytest.mark.parametrize("D", [40, 96, 256, 320])
def test_flash_plain_matches_reference_at_any_head_dim(D):
    rng = np.random.RandomState(D)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        (q, k, v), (jq, jk, jv) = qkv(rng, 1, 4, 2, 128, D, dtype)
        got = ref.flash_attention(q, k, v, causal=True, window=32)
        for want in (jref.flash_attention(jq, jk, jv, causal=True, window=32),
                     JFA.flash_attention(jq, jk, jv, causal=True, window=32,
                                         block_q=64, block_k=64,
                                         interpret=True)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32),
                                       atol=tol, rtol=tol)


@pytest.mark.parametrize("D", [40, 33])
def test_flash_zero_columns_change_no_score(D):
    """The wrapper's padding: q, k, v with zero columns up to the plan's
    template, scaled by D**-0.5 of the true D, give the true D's output in
    the first D columns and zeros after."""
    rng = np.random.RandomState(3)
    (q, k, v), _ = qkv(rng, 1, 2, 1, 96, D)
    want = ref.flash_attention(q, k, v, causal=True)
    pad = FA.plan(D, torch.bfloat16)["template"] - D
    qp, kp, vp = (torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))
    # ref scales by the padded width; undo that on q
    got = ref.flash_attention(qp * math.sqrt((D + pad) / D), kp, vp)
    np.testing.assert_allclose(got[..., :D].numpy(), want.numpy(), atol=1e-6,
                               rtol=1e-5)
    assert not got[..., D:].any()


def ssd_operands(seed, b, L, H, P, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, L, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, L, H))).astype(np.float32)
    A_log = np.log(np.arange(1, H + 1, dtype=np.float32))
    B, C = (rng.randn(b, L, H, N).astype(np.float32) for _ in range(2))
    D = np.ones(H, np.float32)
    return [torch.from_numpy(a) for a in (x, dt, A_log, B, C, D)], \
        [jnp.asarray(a) for a in (x, dt, A_log, B, C, D)]


def ssd_sliced(xdt, a, B, C, chunk):
    """The card's decomposition, plainly: the states by 64-wide slices of
    N and P, the outputs by P slices and passes of up to 128 columns of N
    that add (the fp32 partial)."""
    N, P = B.shape[-1], xdt.shape[-1]
    pl = SSD.plan(*xdt.shape, N, chunk)
    acum, S = ref.ssd_chunk_states(xdt, a, B, chunk)
    for n0, w in pl["n_slices"]:
        for p0, u in pl["p_slices"]:
            S_sl = ref.ssd_chunk_states(xdt[..., p0:p0 + u], a,
                                        B[..., n0:n0 + w], chunk)[1]
            torch.testing.assert_close(S_sl, S[..., n0:n0 + w, p0:p0 + u],
                                       rtol=1e-6, atol=1e-6)
    h = ref.ssd_state_pass(S, acum)
    y = torch.zeros_like(xdt)
    for p0, u in pl["p_slices"]:
        for n0, w, _ in pl["passes"]:
            y[..., p0:p0 + u] += ref.ssd_chunk_outputs(
                xdt[..., p0:p0 + u], B[..., n0:n0 + w], C[..., n0:n0 + w],
                acum, h[..., n0:n0 + w, p0:p0 + u], chunk)
    return y


@pytest.mark.parametrize("b,L,H,P,N,chunk", [
    (1, 128, 2, 64, 128, 64),      # Mamba-2's d_state 128
    (1, 128, 1, 160, 192, 64),     # slices of both axes, two passes
    (1, 1024, 1, 16, 8, 512),      # a chunk above 256
])
def test_ssd_plain_matches_reference_at_any_width(b, L, H, P, N, chunk):
    """The sequential plain version and the card's decomposition (running
    sums in double) against the reference's oracle at 1e-6 and 2e-5, and
    against its Pallas kernel in interpret mode at 2e-5.  At chunk 512 the
    Pallas kernel, which takes its running sums in fp32, is itself 2.46e-5
    of max |y| from its own oracle on these operands (sums near -400): there
    the Pallas comparison is held at 5e-5 and the oracle's at 2e-5."""
    args, jargs = ssd_operands(P + N + chunk, b, L, H, P, N)
    oracle = jref.ssd_scan(*jargs)
    pallas = JSSD.ssd_scan(*jargs, chunk=chunk, interpret=True)
    seq = ref.ssd_scan(*args)
    assert_rel(seq, oracle, 1e-6)
    xdt, a = ref.ssd_prologue(*args[:3])
    y = ssd_sliced(xdt, a, args[3], args[4], chunk) + xdt
    assert_rel(y, oracle, 2e-5)
    for got in (seq, y):
        assert_rel(got, pallas, 2e-5 if chunk <= SSD.MAX_Q else 5e-5)


@pytest.mark.parametrize("L,chunk", [(600, 512), (300, 128)])
def test_ssd_ragged_wide_state(L, chunk):
    """A ragged length (the Pallas kernel gives NaN there) against the
    reference's sequential oracle, at N 160 and P 96."""
    args, jargs = ssd_operands(L, 1, L, 1, 96, 160)
    want = jref.ssd_scan(*jargs)
    assert_rel(ref.ssd_scan(*args), want, 1e-6)
    xdt, a = ref.ssd_prologue(*args[:3])
    assert_rel(ssd_sliced(xdt, a, args[3], args[4], chunk) + xdt, want, 2e-5)


def kd_split(s, t, y, rho, lam, tau, slice_):
    """The split route's arithmetic, plainly in fp32: (1) each slice's
    log-sum-exps of s, s/τ and t/τ, merged in slice order; (2) each slice's
    damped non-true mass, KL terms and S given the row's; (3) their sums in
    order and the true class's term -> the loss."""
    C = s.shape[1]
    st = [(s[:, j:j + slice_], t[:, j:j + slice_] / tau)
          for j in range(0, C, slice_)]
    lse = [torch.logsumexp(torch.stack([torch.logsumexp(x, 1) for x in xs]),
                           0) for xs in zip(*[(a, a / tau, b) for a, b in st])]
    lse_s, lse_st, lse_t = lse
    mass = kl = torch.zeros(s.shape[0])
    for j, (a, b) in zip(range(0, C, slice_), st):
        cls = torch.arange(j, j + a.shape[1])
        d = (1 - rho[j:j + a.shape[1]]) * torch.exp(b - lse_t[:, None])
        d = torch.where(cls[None] == y[:, None], 0.0, d)
        tgt = d.clamp(1e-9, 1.0)
        term = tgt * (torch.log(tgt) - (a / tau - lse_st[:, None]))
        term = torch.where(cls[None] == y[:, None], 0.0, term)
        mass, kl = mass + d.sum(1), kl + term.sum(1)
    s_y = s.gather(1, y[:, None])[:, 0]
    tgt_y = (1 - mass).clamp(1e-9, 1.0)
    kl = (kl + tgt_y * (torch.log(tgt_y) - (s_y / tau - lse_st))) * tau ** 2
    return (1 - lam) * (lse_s - s_y) + lam * kl


def test_kd_plain_and_split_route_match_reference_at_gemma_vocab():
    rng = np.random.RandomState(5)
    B, C = 4, 256000
    s, t = (2 * rng.randn(B, C)).astype(np.float32), \
        (2 * rng.randn(B, C)).astype(np.float32)
    y = rng.randint(0, C, B).astype(np.int32)
    rho = rng.uniform(0.0, 1.0, C).astype(np.float32)
    rho[:5] = 1.0
    want = np.asarray(jref.kd_loss(s, t, y, rho, 0.35, 2.0))
    ts, tt, ty, tr = (torch.from_numpy(a) for a in (s, t, y, rho))
    got = ref.kd_loss(ts, tt, ty.long(), tr[None], 0.35, 2.0)[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-4)
    split = kd_split(ts, tt, ty.long(), tr, 0.35, 2.0, KD.SPLIT_SLICE)
    np.testing.assert_allclose(split.numpy(), want, atol=1e-5, rtol=1e-4)


def test_sparse_plain_and_segments_match_reference_bitwise():
    """One leaf of 27,443,201 elements (the old one-segment limit + 1),
    K 4 x top-k 10%: the plain version against the reference's bit for
    bit, and the segments' sums, each with the pairs in its range, put
    side by side, equal to the whole bit for bit."""
    n, frac = SPARSE_LEAVES[0]
    k = math.ceil(frac * n)
    rng = np.random.RandomState(11)
    w = rng.uniform(0.2, 1.0, K_CLIENTS).astype(np.float32)
    vals = rng.randn(K_CLIENTS, k).astype(np.float32)
    # the top-k wire's unique indices, the last element among them
    idx = np.stack([rng.permutation(k) * (n // k) + rng.randint(0, n // k, k)
                    for _ in range(K_CLIENTS)]).astype(np.int32)
    idx[0, 0] = n - 1
    tv, ti, tw = (torch.from_numpy(a) for a in (vals, idx, w))
    got = ref.sparse_weighted_delta_reduce(tv, ti, tw, (n,), torch.float32)
    want = jref.sparse_weighted_delta_reduce(jnp.asarray(vals),
                                             jnp.asarray(idx), jnp.asarray(w),
                                             (n,), jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    parts = []
    for base, length in SR.segments(n):
        local = ti.long() - base
        local = torch.where((local >= 0) & (local < length), local,
                            torch.full_like(local, -1))
        parts.append(ref.sparse_weighted_delta_reduce(
            tv, local.int(), tw, (length,), torch.float32))
    assert torch.equal(torch.cat(parts), got)


def test_dstate_128_model_path_matches_reference():
    """The model path of the card's check at a reduced width: zamba2 with
    Mamba-2's d_state 128, its reduced two Mamba2 blocks, the kernel route
    (the plain versions here) against the reference's Pallas route."""
    base = get_arch("zamba2-1.2b").reduced()
    cfg = replace(base, ssm=replace(base.ssm, d_state=128))
    jp = jax.jit(lambda key: jT.init(key, jcfg(cfg)))(jax.random.PRNGKey(0))
    p = convert.from_numpy(np_tree(jp), "cpu")
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (1, 128))
    got, _ = PT.forward(p, {"tokens": torch.from_numpy(toks)}, cfg, True)
    want, _ = jT.forward(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         jcfg(cfg), True)
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert_rel(got, want, 2e-5)
