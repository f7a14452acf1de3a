"""The host side of the KD kernels (``kernels/kd_loss.py``): the forward's
cluster route and the backward's tiles, whose shapes the wrapper mirrors
from ``csrc/kd_kernels.cu``; the vmap fold that hands the kernels all
clients' rows in one call; the plain version's identity that the
backward's τ = 1 route relies on; and the backward wrapper's checks.  Pure
Python and CPU tensors; the kernels need the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kd_loss as KD
from repro_torch.kernels import ref


@pytest.mark.parametrize("esize", [4, 2])
def test_cluster_plan_at_the_route_boundaries(esize):
    """One CTA a row up to the C whose s and t fill SLICE_BYTES, two CTAs
    one class later; an LM vocabulary of 32768 takes 4 CTAs in fp32 and 2
    in bf16, each slice of 64 KB (three CTAs an SM)."""
    single = KD.SLICE_BYTES // (2 * esize)
    assert KD.cluster_plan(KD.WARP_MAX_C + 1, esize)[0] == 1
    assert KD.cluster_plan(single, esize) == (1, single,
                                              2 * (single * esize + 16))
    assert KD.cluster_plan(single + 1, esize)[0] == 2
    cl, slice_, smem = KD.cluster_plan(32768, esize)
    assert (cl, slice_ * 2 * esize) == ({4: 4, 2: 2}[esize], KD.SLICE_BYTES)
    assert 3 * smem <= 228 * 1024


@pytest.mark.parametrize("esize", [4, 2])
@pytest.mark.parametrize("n_classes", [1025, 5000, 8193, 32768, 50257,
                                       151936])
def test_cluster_plan_covers_the_row(esize, n_classes):
    """Slices of a multiple of 8 classes (16-byte aligned staging) cover the
    row, every CTA holds some of it, and the shared memory fits."""
    cl, slice_, smem = KD.cluster_plan(n_classes, esize)
    assert cl in (1, 2, 4, 8) and slice_ % 8 == 0
    assert (cl - 1) * slice_ < n_classes <= cl * slice_
    assert smem == 2 * (slice_ * esize + 16) <= KD.MAX_DYN_SMEM


@pytest.mark.parametrize("esize", [4, 2])
def test_max_classes_is_the_largest_planned_row(esize):
    """max_classes is the last C whose plan fits the shared memory a block
    may have; eight classes more (the next slice size) do not fit."""
    top = KD.max_classes(esize)
    assert KD.cluster_plan(top, esize)[2] <= KD.MAX_DYN_SMEM
    assert KD.cluster_plan(top + 8, esize)[2] > KD.MAX_DYN_SMEM
    assert top > 151936          # the largest vocabulary of the repo's LMs


def test_fold_makes_views_and_keeps_one_group_rho():
    """Operands batched at dim 0 fold to views (no copy); an operand batched
    elsewhere moves its batch dim first; an unbatched ρ of one group stays
    (1, C), one group for every row, and one of G groups is expanded to
    K·G."""
    K, b, C = 3, 4, 5
    s = torch.randn(K, b, C)
    t_other = torch.randn(b, K, C)
    labels = torch.randint(0, C, (K, b))
    rho1, rho2 = torch.rand(1, C), torch.rand(2, C)
    fs, ft, fy, fr = KD._fold(K, (0, 1, 0, None), (s, t_other, labels, rho1))
    assert fs.data_ptr() == s.data_ptr() and fs.shape == (K * b, C)
    assert fy.data_ptr() == labels.data_ptr()
    assert torch.equal(ft, t_other.movedim(1, 0).reshape(K * b, C))
    assert fr is rho1
    (fr2,) = KD._fold(K, (None, None, None, None), (s, s, labels, rho2))[3:]
    assert fr2.shape == (K * 2, C) and torch.equal(fr2[2:4], rho2)


@pytest.mark.parametrize("n_classes", [1, 3, 10, 37, 100, 257, 1024, 1025,
                                       32768, 50257])
def test_bwd_tiles_cover_every_element_once(n_classes):
    """The backward's tiles, as launch_bwd plans them and kd_bwd_kernel
    walks them, put every (row, class) of (rows, C) in exactly one tile of
    at most BWD_TILE elements: above BWD_TILE a row's chunks in order,
    else whole rows (at most BWD_MAX_ROWS), consecutive tiles adjacent in
    the flattened logits; fewer than 2^31 tiles (blockIdx.x).  Within a
    tile of whole rows, element k's row is __umulhi(k, ceil(2^32 / C))
    (the magic 0 of C = 1 meaning k itself), its class k minus C rows."""
    C, W = n_classes, KD.BWD_TILE
    magic = ((1 << 32) + C - 1) // C % (1 << 32)
    for rows in (1, 7, 512, 1024, 70000):
        tiles, per, wide = KD.bwd_plan(rows, C)
        assert wide == (C > W) and 0 < tiles < 2 ** 31
        b = np.arange(tiles, dtype=np.int64)
        if wide:
            row, chunk = b // per, b % per
            lo = row * C + chunk * W
            n = np.minimum(C - chunk * W, W)
            assert (chunk * W + n <= C).all()     # a chunk stays in its row
        else:
            assert 1 <= per <= KD.BWD_MAX_ROWS and per * C <= W
            nr = np.minimum(per, rows - b * per)
            lo, n = b * per * C, nr * C
            assert (nr > 0).all()
        assert ((n > 0) & (n <= W)).all()
        assert lo[0] == 0 and lo[-1] + n[-1] == rows * C
        assert (lo[1:] == lo[:-1] + n[:-1]).all()
    if C <= W:
        k = np.arange(KD.bwd_plan(70000, C)[1] * C, dtype=np.uint64)
        q = k if magic == 0 else (k * np.uint64(magic)) >> np.uint64(32)
        assert (q == k // np.uint64(C)).all()


def test_bwd_plan_at_the_tile_boundary():
    """One whole row a tile at C = BWD_TILE and one under it, two chunks a
    row one class over; 8 rows of 32768 classes make 256 tiles, and the
    CNN's (512, 10) 102 rows a tile, 6 tiles."""
    W = KD.BWD_TILE
    assert KD.bwd_plan(64, W - 1) == (64, 1, False)
    assert KD.bwd_plan(64, W) == (64, 1, False)
    assert KD.bwd_plan(64, W + 1) == (128, 2, True)
    assert KD.bwd_plan(8, 32768) == (256, 32, True)
    assert KD.bwd_plan(512, 10) == (6, 102, False)
    assert KD.bwd_plan(1000, 1) == (4, KD.BWD_MAX_ROWS, False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unit_tau_stats_share_the_lse(dtype):
    """The τ = 1 route's invariant, in the plain version: at τ = 1
    ref.kd_loss's lse and lse_tau are equal bit for bit (s / 1 is s), so
    softmax(s/τ) is p itself: ref.kd_loss_bwd's closed form with p put in
    place of p_τ gives its bits, on rows with a label out of range and
    ±inf logits too."""
    g = torch.Generator().manual_seed(3)
    s, t = ((2 * torch.randn(64, 37, generator=g)).to(dtype) for _ in range(2))
    y = torch.randint(0, 37, (64,), generator=g)
    rho = torch.rand(4, 37, generator=g)
    y[0] = 37
    s[1, :5], s[2, 7] = float("-inf"), float("inf")
    t[3, 9] = float("inf")
    up = torch.rand(64, generator=g)
    stats = ref.kd_loss(s, t, y, rho, 0.35, 1.0)[3]
    assert torch.equal(stats[:, 0].view(torch.int32),
                       stats[:, 1].view(torch.int32))
    sf = s.float()
    lse, _, lse_t, true_mass, tsum = (c[:, None] for c in stats.unbind(-1))
    onehot = ref.one_hot(y, 37)
    p = torch.exp(sf - lse)
    p_t = torch.exp(t.float() / 1.0 - lse_t)
    tgt = torch.clamp(torch.where(onehot > 0, true_mass,
                                  (1.0 - ref.row_rho(rho, 64)) * p_t),
                      1e-9, 1.0)
    want = (up[:, None] * ((1 - 0.35) * (p - onehot)
                           + 0.35 * 1.0 * (tsum * p - tgt))).to(dtype)
    got = ref.kd_loss_bwd(s, t, y, rho, stats, up, 0.35, 1.0)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(), want.nan_to_num())


class OnCard:
    """A CPU tensor that answers the wrapper's checks as one on cuda:0 (or
    the given index) would: enough to reach each of its error messages
    without a card."""

    def __init__(self, x, index=0, contiguous=True):
        self.x, self.index, self.contiguous = x, index, contiguous
        self.is_cuda = True
        self.device = torch.device("cuda", index)
        self.dtype, self.shape = x.dtype, x.shape

    def dim(self):
        return self.x.dim()

    def get_device(self):
        return self.index

    def is_contiguous(self):
        return self.contiguous


def bwd_operands(rows=8, n_classes=10):
    s = OnCard(torch.zeros(rows, n_classes))
    return (s, OnCard(torch.zeros(rows, n_classes)),
            OnCard(torch.zeros(rows, dtype=torch.int64)),
            OnCard(torch.ones(2, n_classes)))


@pytest.mark.parametrize("what,stats,g,match", [
    ("stats rows", torch.zeros(7, 5), torch.zeros(8), r"\(8, 5\) is needed"),
    ("stats columns", torch.zeros(8, 4), torch.zeros(8),
     r"\(8, 5\) is needed"),
    ("stats dtype", torch.zeros(8, 5, dtype=torch.bfloat16), torch.zeros(8),
     "torch.bfloat16 .* where torch.float32"),
    ("g rows", torch.zeros(8, 5), torch.zeros(9), r"\(8,\) is needed"),
    ("g dtype", torch.zeros(8, 5), torch.zeros(8, dtype=torch.float64),
     "torch.float64 .* where torch.float32"),
])
def test_bwd_wrapper_refuses_malformed_stats_and_g(what, stats, g, match):
    """The backward's one test of its operands fails on statistics that are
    not (rows, 5) fp32 or an upstream gradient that is not (rows,) fp32,
    and the messages name what is needed."""
    s, t, labels, rho = bwd_operands()
    assert KD._fits(s, t, labels, rho)
    with pytest.raises(ValueError, match=match):
        KD.kd_loss_bwd(s, t, labels, rho, OnCard(stats), OnCard(g), 0.35, 1.0)


def test_bwd_wrapper_refuses_cpu_strided_and_foreign_operands():
    """CPU operands, statistics off the logits' card and a non-contiguous g
    are refused with the messages of check_operands, and rows that do not
    split into ρ's groups by _check's."""
    s, t, labels, rho = bwd_operands()
    stats, g = OnCard(torch.zeros(8, 5)), OnCard(torch.zeros(8))
    x = torch.zeros(8, 10)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        KD.kd_loss_bwd(x, x, torch.zeros(8, dtype=torch.int64),
                       torch.ones(1, 10), torch.zeros(8, 5), torch.zeros(8),
                       0.35, 1.0)
    with pytest.raises(ValueError, match="operands on cuda:0 and cuda:1"):
        KD.kd_loss_bwd(s, t, labels, rho, OnCard(torch.zeros(8, 5), index=1),
                       g, 0.35, 1.0)
    with pytest.raises(ValueError, match="must be contiguous"):
        KD.kd_loss_bwd(s, t, labels, rho, stats,
                       OnCard(torch.zeros(8), contiguous=False), 0.35, 1.0)
    with pytest.raises(ValueError, match="do not split into 3 groups"):
        KD.kd_loss_bwd(s, t, labels, OnCard(torch.ones(3, 10)), stats, g,
                       0.35, 1.0)


def _transformed_grads(how):
    """∂ mean loss / ∂ logits of K=3 clients through ops.kd_loss (the
    Functions and their vmap rules) under one composition of transforms,
    and the same from a Python loop over clients of the plain version."""
    from repro_torch.kernels import ops
    k, b, C = 3, 5, 7
    g = torch.Generator().manual_seed(1)
    s, t = (torch.randn(k, b, C, generator=g) for _ in range(2))
    y = torch.randint(0, C, (k, b), generator=g)
    rho = torch.rand(k, C, generator=g)

    def f(s, t, y, r):
        return ops.kd_loss(s, t, y, r, 0.35, 1.0)[0].mean()

    def plain(s, t, y, r):
        return ref.kd_loss(s, t, y, r.reshape(1, -1), 0.35, 1.0)[0].mean()
    want = torch.stack([torch.func.grad(plain)(s[i], t[i], y[i], rho[i])
                        for i in range(k)])
    if how == "vmap(grad)":
        return torch.func.vmap(torch.func.grad(f))(s, t, y, rho), want
    if how == "grad(vmap)":
        return torch.func.grad(
            lambda s: torch.func.vmap(f)(s, t, y, rho).sum())(s), want
    if how == "autograd through vmap":
        s = s.clone().requires_grad_()
        torch.func.vmap(f)(s, t, y, rho).sum().backward()
        return s.grad, want
    if how == "vmap(vmap(grad))":
        got = torch.func.vmap(torch.func.vmap(torch.func.grad(f)))(
            s[None], t[None], y[None], rho[None])
        return got[0], want
    # vmap over a vjp's cotangents: the backward's rule with no forward rows
    _, vjp = torch.func.vjp(
        lambda s0: ops.kd_loss(s0, t[0], y[0], rho[0], 0.35, 1.0)[0], s[0])
    gs = torch.rand(4, b, generator=g)
    return (torch.func.vmap(vjp)(gs)[0],
            torch.stack([vjp(gi)[0] for gi in gs]))


@pytest.mark.parametrize("how", ["vmap(grad)", "grad(vmap)",
                                 "autograd through vmap", "vmap(vmap(grad))",
                                 "vmap(vjp)"])
def test_vmap_rules_under_each_transform(how):
    """The vmap rules fold the clients into rows, hand the forward's rows
    to the backward's rule, and run a Function's forward without a second
    custom-Function dispatch only where no transform below and no autograd
    record needs it: under every composition the gradient equals the loop
    over clients' within 1e-6 of its largest magnitude (the same plain
    arithmetic, reduced over other batch shapes)."""
    got, want = _transformed_grads(how)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
