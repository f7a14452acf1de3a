"""Tests of the port that need a CUDA card; each skips without one: the
kernels against their plain versions (the two sweep kernels over more
leaves than one leaf table holds), and rounds of the simulator on
the card (plain wire, dense and sparse top-k, FedADC+).

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import tree as T
from repro_torch.data.partition import sort_and_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.simulator import FederatedSimulator, SimConfig
from repro_torch.kernels import compress as CP
from repro_torch.kernels import fedadc_update as FU
from repro_torch.kernels import kd_loss as KD
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_reduce as SR
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels import weighted_reduce as WR


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dtype):
    """Each CUDA kernel equals its plain version on the card, bit for bit:
    both round every multiply and add in fp32 on its own, and the reduce
    sums the clients in the same order."""
    need_card()
    g = torch.Generator().manual_seed(0)
    for n in (1, 10, 130, 1290, 100_003):
        x, y, z = (torch.randn(n, generator=g).to("cuda", dtype)
                   for _ in range(3))
        m, d = (torch.randn(n, generator=g).cuda() for _ in range(2))
        assert torch.equal(FU.fused_axpy(x, y, -0.05),
                           ref.fused_axpy(x, y, -0.05))
        assert torch.equal(FU.local_update(x, y, z, 0.05),
                           ref.fedadc_local_update(x, y, z, 0.05))
        for a, b in zip(FU.server_update(x, m, d, 0.2, 0.05),
                        ref.fedadc_server_update(x, m, d, 0.2, 0.05)):
            assert torch.equal(a, b)
        stack = torch.randn(8, n, generator=g).to("cuda", dtype)
        w = torch.rand(8, generator=g).cuda()
        assert torch.equal(WR.weighted_reduce(stack, w),
                           ref.weighted_delta_reduce(stack, w))
    torch.cuda.synchronize()


def update_rel_err(card, cpu, start):
    """‖Δθ_card − Δθ_cpu‖ / ‖Δθ_cpu‖ over the whole model, Δθ = θ − θ_0."""
    num = sum(((a.cpu() - b) ** 2).sum()
              for a, b in zip(T.leaves(card), T.leaves(cpu)))
    den = sum(((b - s) ** 2).sum()
              for b, s in zip(T.leaves(cpu), T.leaves(start)))
    return (num / den).sqrt().item()


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["nesterov", "heavyball"])
def test_round_on_the_card_matches_the_cpu(variant):
    """Two one-step FedADC rounds (the second with momentum) on the card,
    TF32 off, and on the CPU from the same parameters and batches: the
    updates agree within 1e-4 relative.  Each step is one gradient, where
    cuDNN's and oneDNN's fp32 convolutions differ only in summation order
    (~1e-5 relative at most); more local steps amplify that through ReLU
    and max-pool switches, so this check keeps H=1.  The card's rounds
    launch the kernels."""
    need_card()
    x, y, xt, yt = make_image_dataset(400, 50, 10, image_size=16)
    parts = sort_and_partition(y, 10, s=2)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sims = []
        ops.reset_launch_counts()
        for device in ("cuda", "cpu"):
            s = FederatedSimulator(
                FedConfig(variant=variant, local_steps=1, clients_per_round=3,
                          n_clients=10, eta=0.01),
                SimConfig(batch_size=16, cnn_width=8, seed=3), x, y, xt, yt,
                parts, device=device)
            start = T.tree_map(lambda t: t.cpu().clone(), s.params)
            for _ in range(2):
                s.run_round(*s.next_round_inputs())
            sims.append(s)
        counts = ops.launch_counts()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    step_kernel = "fused_axpy" if variant == "nesterov" else "local_update"
    assert counts[step_kernel] > 0 and counts["weighted_reduce"] > 0
    assert counts["server_update"] > 0
    assert update_rel_err(sims[0].params, sims[1].params, start) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wire_kernels_match_plain(dtype):
    """The threshold select and QSGD on a leaf stacked over 8 clients, one
    scalar per row, equal their plain versions bit for bit (QSGD rounds to
    the operand dtype after every op on both sides); a zero row gives exact
    zeros."""
    need_card()
    g = torch.Generator().manual_seed(1)
    for n in (1, 10, 130, 1290, 100_003):
        v = torch.randn(8, n, generator=g).to("cuda", dtype)
        v[3] = 0
        tau = torch.topk(v.abs(), max(1, n // 10),
                         dim=1).values[:, -1].contiguous()
        for a, b in zip(CP.threshold_select(v, tau),
                        ref.topk_threshold_select(v, tau)):
            assert torch.equal(a, b)
        u = torch.rand(8, n, generator=g).to("cuda", dtype)
        scale = torch.amax(v.abs(), dim=1)
        for s in (3, 15, 255):
            q, r = CP.qsgd(v, u, scale, s)
            qe, re = ref.qsgd_quantize(v, u, scale, s)
            assert torch.equal(q, qe) and torch.equal(r, re)
            assert not q[3].any() and not r[3].any()
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("vdt,odt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
def test_sparse_reduce_matches_plain(vdt, odt):
    """Bit for bit with the plain version: random indices with duplicates
    within a client (pair order decides the rounding), unique top-k-like
    wires over several output tiles, a scalar leaf and an empty wire."""
    need_card()
    g = torch.Generator().manual_seed(2)
    cases = [(6, 97, 2048), (3, 5, 17), (4, 1, 1), (8, 2000, 20_000)]
    for k_clients, k, n in cases:
        vals = torch.randn(k_clients, k, generator=g).to("cuda", vdt)
        for idx in (torch.randint(0, n, (k_clients, k), generator=g),
                    torch.stack([torch.randperm(n, generator=g)[:k]
                                 for _ in range(k_clients)])):
            idx = idx.to("cuda", torch.int32)
            w = torch.rand(k_clients, generator=g).cuda()
            got = SR.sparse_reduce(vals, idx, w, (n,), odt)
            want = ref.sparse_weighted_delta_reduce(vals, idx, w, (n,), odt)
            assert torch.equal(got, want)
    empty = SR.sparse_reduce(torch.zeros((2, 0), device="cuda", dtype=vdt),
                             torch.zeros((2, 0), device="cuda",
                                         dtype=torch.int32),
                             torch.ones(2, device="cuda"), (8,), odt)
    assert not empty.any()
    dup = SR.sparse_reduce(
        torch.tensor([[1.0, 2.0, 4.0], [8.0, 16.0, 32.0]], device="cuda",
                     dtype=vdt),
        torch.tensor([[5, 5, 5], [5, 5, 2]], device="cuda",
                     dtype=torch.int32),
        torch.ones(2, device="cuda"), (8,), odt).float().cpu()
    assert dup[5] == 31 and dup[2] == 32 and dup.sum() == 63
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_axpy_sweep_over_many_leaves(dtype):
    """One sweep over 70 leaves (two leaf-table groups, so two launches) of
    mixed lengths — empty, off the 2048-element tile, one not 16-byte
    aligned — equals the plain version leaf by leaf, bit for bit."""
    need_card()
    g = torch.Generator().manual_seed(8)
    lengths = [0, 1, 7, 2047, 2048, 2049, 100_003] * 10
    xs = [torch.randn(3, n, generator=g).to("cuda", dtype) for n in lengths]
    ys = [torch.randn(3, n, generator=g).to("cuda", dtype) for n in lengths]
    xs[5] = torch.randn(3 * 2049 + 1, generator=g).to("cuda", dtype)[1:]
    ys[5] = ys[5].reshape(-1)
    ops.reset_launch_counts()
    got = FU.fused_axpy_leaves(xs, ys, -0.05)
    assert ops.launch_counts()["fused_axpy"] == 2
    for o, x, y in zip(got, xs, ys):
        assert o.shape == x.shape and torch.equal(o, ref.fused_axpy(x, y,
                                                                    -0.05))
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_tables_match_plain(dtype):
    """The local and server update tables over the paper CNN's 16 leaves,
    ResNet-18's 76 (two table groups) and an edge sweep of 70 (empty
    leaves, lengths off the 2048-element tile, one leaf not 16-byte
    aligned): θ in `dtype` beside the fp32 momentum, Δ in θ's dtype and in
    fp32 with the scale 1/η folded in, each leaf bit for bit its plain
    version; one launch per 64 leaves."""
    need_card()
    from repro_torch.models.vision import cnn_init, resnet18_init
    g = torch.Generator().manual_seed(11)
    sweeps = [[tuple(t.shape) for t in T.leaves(p)] for p in (
        cnn_init(0, width=32, image_size=32, device="cpu"),
        resnet18_init(0, n_classes=100, device="cpu"))]
    sweeps.append([(n,) for n in [0, 1, 7, 2047, 2048, 2049, 100_003] * 10])
    for shapes in sweeps:
        def rnd(dt):
            return [torch.randn(s, generator=g).to("cuda", dt)
                    for s in shapes]
        th, gs, mb, m = rnd(dtype), rnd(dtype), rnd(dtype), rnd(torch.float32)
        if len(shapes) == 70:   # one element past an aligned start
            th[5] = torch.randn(2049 + 1, generator=g).to("cuda", dtype)[1:]
        ops.reset_launch_counts()
        got = FU.local_update_leaves(th, gs, mb, 0.05)
        for o, t, gi, mi in zip(got, th, gs, mb):
            assert o.shape == t.shape and o.dtype == dtype
            assert torch.equal(o, ref.fedadc_local_update(t, gi, mi, 0.05))
        for ddt in (dtype, torch.float32):
            ds = rnd(ddt)
            got_t, got_m = FU.server_update_leaves(th, m, ds, 0.2, 0.05,
                                                   scale=1 / 0.03)
            for ot, om, t, mi, d in zip(got_t, got_m, th, m, ds):
                want_t, want_m = ref.fedadc_server_update(t, mi, d, 0.2, 0.05,
                                                          1 / 0.03)
                assert ot.dtype == dtype and om.dtype == torch.float32
                assert torch.equal(ot, want_t) and torch.equal(om, want_m)
        groups = -(-len(shapes) // 64)
        assert ops.launch_counts()["local_update"] == groups
        assert ops.launch_counts()["server_update"] == 2 * groups
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_update_tables_refuse_what_the_kernels_do_not_take():
    """Leaves of mixed dtypes, a momentum not in fp32 and non-contiguous
    operands raise on the card before any launch."""
    need_card()
    x = torch.randn(4, 10, device="cuda")
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="bfloat16"):
        FU.local_update_leaves([x, x.bfloat16()], [x, x.bfloat16()],
                               [x, x.bfloat16()], 0.05)
    with pytest.raises(ValueError, match="float32"):
        FU.server_update_leaves([x], [x.bfloat16()], [x], 0.2, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        FU.local_update_leaves([x.t()], [x.t()], [x.t()], 0.05)
    assert ops.launch_counts()["local_update"] == 0
    assert ops.launch_counts()["server_update"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("vdt,odt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
def test_sparse_reduce_sweep_over_many_leaves(vdt, odt):
    """One call over 70 leaves (two table groups): unique and duplicate
    indices, out-of-range indices, k = 0, an empty leaf and lengths off the
    8192-element tile, each leaf bit for bit with the plain version."""
    need_card()
    g = torch.Generator().manual_seed(9)
    K = 4
    vals, idxs, shapes = [], [], []
    for i in range(70):
        n = (0, 1, 97, 8193, 20_000)[i % 5]
        k = 0 if i % 7 == 3 or n == 0 else max(1, n // (3 + i % 4))
        vals.append(torch.randn(K, k, generator=g).to("cuda", vdt))
        if i % 3 == 0:
            idx = torch.randint(-5, n + 5, (K, k), generator=g)
        elif i % 3 == 1 and k <= n:
            idx = torch.stack([torch.randperm(n, generator=g)[:k]
                               for _ in range(K)])
        else:
            idx = torch.randint(0, max(n, 1), (K, k), generator=g)
        idxs.append(idx.to("cuda", torch.int32))
        shapes.append((n,))
    w = torch.rand(K, generator=g).cuda()
    ops.reset_launch_counts()
    got = SR.sparse_reduce_leaves(vals, idxs, w, shapes, odt)
    assert ops.launch_counts()["sparse_reduce"] == 1
    for o, v, i, sh in zip(got, vals, idxs, shapes):
        assert torch.equal(o, ref.sparse_weighted_delta_reduce(v, i, w, sh,
                                                               odt))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_sparse_reduce_bf16_k96_vs_fp64():
    need_card()
    K, N, k = 96, 4096, 409
    g = torch.Generator().manual_seed(7)
    vals = (1.0 + 0.05 * torch.randn(K, k, generator=g)).to(torch.bfloat16)
    idx = torch.stack([torch.randperm(N, generator=g)[:k] for _ in range(K)])
    w = torch.rand(K, generator=g) * 0.8 + 0.2
    oracle = torch.zeros(N, dtype=torch.float64)
    oracle.index_add_(0, idx.reshape(-1),
                      (w.double()[:, None] * vals.double()).reshape(-1))
    got = SR.sparse_reduce(vals.cuda(), idx.to("cuda", torch.int32),
                           w.cuda(), (N,), torch.float32).double().cpu()
    assert torch.all((got - oracle).abs() <= oracle.abs() * 2.0 ** -8 + 1e-7)


@pytest.mark.gpu
def test_dense_and_sparse_topk_rounds_on_the_card():
    """One FedADC round on the card under the dense top-k wire and under
    the sparse wire with its sparse aggregate, from the same parameters and
    batches (cuDNN deterministic): the select and the reduce kernels launch,
    and the two updates agree within 1e-3 relative.  The reconstructions
    are equal except where magnitudes tie at the threshold (the dense
    select keeps every tied entry, the sparse wire exactly k), and both
    aggregates sum in fp32 in client order."""
    need_card()
    x, y, xt, yt = make_image_dataset(400, 50, 10, image_size=16)
    parts = sort_and_partition(y, 10, s=2)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        updates, counts = [], []
        for kw in ({}, {"sparse_uplink": True}):
            ops.reset_launch_counts()
            s = FederatedSimulator(
                FedConfig(compressor="topk", topk_frac=0.1, local_steps=2,
                          clients_per_round=3, n_clients=10, eta=0.01, **kw),
                SimConfig(batch_size=16, cnn_width=8, seed=3), x, y, xt, yt,
                parts, device="cuda")
            start = T.tree_map(lambda t: t.clone(), s.params)
            s.run_round(*s.next_round_inputs())
            updates.append(T.sub(s.params, start))
            counts.append(ops.launch_counts())
    finally:
        torch.backends.cudnn.deterministic = det
    n_leaves = len(T.leaves(updates[0]))
    # the dense select is one launch a compress per 64 leaves
    assert counts[0]["threshold_select"] == -(-n_leaves // 64)
    assert counts[0]["sparse_reduce"] == 0
    # the sparse aggregate is one call for all leaves
    assert counts[1]["sparse_reduce"] == 1
    assert counts[1]["threshold_select"] == 0
    num = sum(((a - b) ** 2).sum() for a, b in zip(T.leaves(updates[0]),
                                                   T.leaves(updates[1])))
    den = sum((a ** 2).sum() for a in T.leaves(updates[0]))
    assert (num / den).sqrt().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kd_kernels_match_plain(dtype):
    """The KD forward and backward kernels against their plain versions at
    the reference sweep's shapes, the main path's folded (512, 10) with 8
    groups of ρ, and a C above the one-warp-a-row limit.  Forward (loss,
    CE, KL and the statistics) within the reference's bar, atol 1e-5 and
    rtol 1e-4; backward within 1e-5 of the gradient's largest magnitude.
    Neither is bit for bit: the kernels reduce each row in another order
    than ``logsumexp`` and ``sum`` do.  One ρ class is fully confident, so
    its target sits at the clip."""
    need_card()
    g = torch.Generator().manual_seed(4)
    for rows, n_classes, groups in ((8, 10, 1), (64, 37, 1), (128, 100, 1),
                                    (31, 257, 1), (512, 10, 8),
                                    (6, 3000, 2)):
        s, t = ((2 * torch.randn(rows, n_classes, generator=g)).to("cuda",
                                                                    dtype)
                for _ in range(2))
        y = torch.randint(0, n_classes, (rows,), generator=g).cuda()
        rho = torch.rand(groups, n_classes, generator=g).cuda()
        rho[:, 0] = 1.0
        got = KD.kd_loss(s, t, y, rho, 0.35, 2.0)
        want = ref.kd_loss(s, t, y, rho, 0.35, 2.0)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
        up = torch.rand(rows, generator=g).cuda()
        ds = KD.kd_loss_bwd(s, t, y, rho, got[3], up, 0.35, 2.0)
        ds_plain = ref.kd_loss_bwd(s, t, y, rho, got[3], up, 0.35, 2.0)
        assert ds.dtype == dtype
        err = (ds.float() - ds_plain.float()).abs().max()
        assert err <= 1e-5 * ds_plain.float().abs().max()
    torch.cuda.synchronize()


def bwd_share(ds, want):
    """The KD backward's error over its plain version's largest magnitude
    on the finite entries, after NaN and ±inf are found where the plain
    version has them."""
    a, b = ds.float(), want.float()
    assert torch.equal(a.isnan(), b.isnan())
    inf = b.isinf()
    assert torch.equal(a[inf], b[inf])
    fin = torch.isfinite(b)
    return ((a[fin] - b[fin]).abs().max() / b[fin].abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kd_backward_tiles_and_routes_match_plain(dtype):
    """The KD backward on both of its routes, τ = 1 (p for softmax(s/τ), two
    exps) and τ = 3 (three), against ref.kd_loss_bwd from the same
    statistics within 1e-5 of the gradient's largest magnitude: C one under,
    at and one over the tile (whole rows a tile, two chunks a row), rows off
    a 16-byte boundary, 3 classes (many rows a tile), 8 rows of 32768
    (256 tiles); s and t one element off a 16-byte boundary give the same
    bits (every element alone); and rows with a label out of range and
    ±inf logits, NaN and ±inf where the plain version has them."""
    need_card()
    g = torch.Generator().manual_seed(21)
    W = KD.BWD_TILE

    def operands(rows, C, groups):
        s, t = ((2 * torch.randn(rows, C, generator=g)).to("cuda", dtype)
                for _ in range(2))
        y = torch.randint(0, C, (rows,), generator=g).cuda()
        rho = torch.rand(groups, C, generator=g).cuda()
        rho[:, 0] = 1.0
        return s, t, y, rho, torch.rand(rows, generator=g).cuda()

    for rows, C, groups in ((64, W - 1, 4), (64, W, 4), (64, W + 1, 4),
                            (31, 257, 1), (300, 3, 3), (512, 10, 8),
                            (8, 32768, 1)):
        s, t, y, rho, up = operands(rows, C, groups)
        for tau in (1.0, 3.0):
            st = KD.kd_loss(s, t, y, rho, 0.35, tau)[3]
            ds = KD.kd_loss_bwd(s, t, y, rho, st, up, 0.35, tau)
            assert ds.dtype == dtype
            want = ref.kd_loss_bwd(s, t, y, rho, st, up, 0.35, tau)
            assert bwd_share(ds, want) <= 1e-5
        off = [torch.empty(rows * C + 1, dtype=dtype, device="cuda")[1:]
               .view(rows, C).copy_(x) for x in (s, t)]
        assert torch.equal(KD.kd_loss_bwd(*off, y, rho, st, up, 0.35, 3.0),
                           ds)
    for C in (10, W + 1, 32768):
        s, t, y, rho, up = operands(8, C, 2)
        half = torch.arange(C, device="cuda") < C // 2
        y[0], y[2], y[3], y[4] = C, 0, C - 1, C - 1
        t[1, half] = float("-inf")
        t[2, 3], t[2, 5] = float("inf"), float("-inf")
        s[3, half] = float("-inf")
        s[4, 1] = float("inf")
        for tau in (1.0, 3.0):
            st = KD.kd_loss(s, t, y, rho, 0.35, tau)[3]
            ds = KD.kd_loss_bwd(s, t, y, rho, st, up, 0.35, tau)
            want = ref.kd_loss_bwd(s, t, y, rho, st, up, 0.35, tau)
            assert bwd_share(ds, want) <= 1e-5
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_fedadc_plus_rounds_on_the_card_match_the_cpu():
    """Two one-step FedADC+ rounds on the card (TF32 off) and on the CPU
    from the same parameters and batches agree within 1e-4 relative, as
    the plain FedADC rounds do; each step launches the KD forward and
    backward kernels once for all clients."""
    need_card()
    x, y, xt, yt = make_image_dataset(400, 50, 10, image_size=16)
    parts = sort_and_partition(y, 10, s=2)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        sims = []
        ops.reset_launch_counts()
        for device in ("cuda", "cpu"):
            s = FederatedSimulator(
                FedConfig(distill=True, local_steps=1, clients_per_round=3,
                          n_clients=10, eta=0.01),
                SimConfig(batch_size=16, cnn_width=8, seed=3), x, y, xt, yt,
                parts, device=device)
            start = T.tree_map(lambda t: t.cpu().clone(), s.params)
            for _ in range(2):
                s.run_round(*s.next_round_inputs())
            sims.append(s)
        counts = ops.launch_counts()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert counts["kd_loss"] == 2 and counts["kd_loss_bwd"] == 2
    assert update_rel_err(sims[0].params, sims[1].params, start) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dtype):
    """The flash kernel against its plain version at the reference sweep's
    shapes (MHA, GQA 2, MQA at D 128, L 192 not a multiple of the tile),
    its windows, and a GQA 32/8 at D 128 (Qwen3's heads): within the
    reference's bars, 2e-5 (fp32) and 2e-2 (bf16); the kernel's online
    softmax sums over 64-key tiles, the plain version over the row."""
    need_card()
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator().manual_seed(5)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for B, H, Hk, L, D, window in ((1, 2, 2, 128, 64, 0),
                                   (2, 4, 2, 256, 64, 0),
                                   (1, 8, 1, 128, 128, 0),
                                   (1, 4, 4, 192, 64, 0),
                                   (1, 2, 2, 256, 64, 32),
                                   (1, 2, 2, 256, 64, 64),
                                   (1, 2, 2, 256, 64, 128),
                                   (1, 32, 8, 300, 128, 0)):
        q = torch.randn(B, L, H, D, generator=g).to("cuda", dtype)
        k, v = (torch.randn(B, L, Hk, D, generator=g).to("cuda", dtype)
                for _ in range(2))
        got = FA.flash_attention(q, k, v, True, window)
        want = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), True,
                                   window).transpose(1, 2)
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain(dtype):
    """The SSD kernels (through ``ops.ssd_scan``, prologue and D term
    included: one counted call of three device kernels) against the plain
    sequential recurrence at the reference sweep's shapes, ragged lengths
    (L 100 at chunk 64, L 300 and L 1100 at chunk 256), L shorter than a
    chunk, P 12 and N 10 (the copies element by element), batch 1 at L 4096
    (the carry crosses 16 chunks) and decays large enough that exp(a_end)
    underflows to 0: within 2e-5 (fp32) and 5e-2
    (bf16) of the output's largest magnitude, the reference's bars; the
    running sums and the states left in device memory against the plain
    phases.  In bf16, the tensor-core route also with an fp32 output,
    within 1e-4 of max |y|: its split (hi + lo) operands keep the products
    near fp32, where a single bf16 rounding of the scores or of x would
    not."""
    need_card()
    g = torch.Generator().manual_seed(6)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    for b, L, H, P, N, chunk, dt_scale in ((1, 64, 2, 16, 8, 16, 1),
                                           (2, 128, 4, 32, 16, 32, 1),
                                           (1, 256, 2, 64, 64, 64, 1),
                                           (2, 96, 3, 16, 8, 32, 1),
                                           (2, 100, 4, 32, 16, 64, 1),
                                           (1, 300, 4, 64, 64, 256, 1),
                                           (1, 1100, 4, 64, 64, 256, 1),
                                           (1, 50, 2, 64, 64, 256, 1),
                                           (1, 64, 2, 12, 10, 16, 1),
                                           (1, 4096, 2, 64, 64, 256, 1),
                                           (1, 1024, 4, 64, 64, 256, 40)):
        x = torch.randn(b, L, H, P, generator=g).to("cuda", dtype)
        dt = dt_scale * torch.nn.functional.softplus(
            torch.randn(b, L, H, generator=g)).cuda()
        A_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32)).cuda()
        Bm, Cm = (torch.randn(b, L, H, N, generator=g).to("cuda", dtype)
                  for _ in range(2))
        D = torch.ones(H, device="cuda")
        ops.reset_launch_counts()
        got = ops.ssd_scan(x, dt, A_log, Bm, Cm, D, chunk)
        assert ops.launch_counts()["ssd_scan"] == 1
        want = ref.ssd_scan(x, dt, A_log, Bm, Cm, D)
        assert torch.isfinite(got).all()
        err = (got - want).abs().max() / want.abs().max()
        assert err <= tol
        xdt, a = ref.ssd_prologue(x, dt, A_log)
        Q = min(chunk, L)
        _, acum, state = SSD.ssd_scan(xdt, a, Bm, Cm, Q, dtype,
                                      intermediates=True)
        r_acum, r_S = ref.ssd_chunk_states(xdt, a, Bm, Q)
        r_h = ref.ssd_state_pass(r_S, r_acum)
        torch.testing.assert_close(acum[..., :Q], r_acum, rtol=0, atol=1e-9)
        h_err = (state[..., :N, :P] - r_h).abs().max()
        assert h_err <= 1e-4 * r_h.abs().max() + 1e-30
        assert not state[..., N:, :].any() and not state[..., P:].any()
        if dtype == torch.bfloat16:
            got32 = SSD.ssd_scan(xdt, a, Bm, Cm, Q, torch.float32)
            want32 = ref.ssd_recurrence(xdt, a, Bm, Cm)
            assert ((got32 - want32).abs().max()
                    <= 1e-4 * want32.abs().max())
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qsgd_tree_matches_per_leaf_kernel(dtype):
    """One QSGD sweep over 70 leaves stacked over 8 clients (two leaf-table
    groups: two launches), with an all-zero leaf, a NaN in one row and a
    -0.0: the tree call, its per-row scales computed in the call, equals the
    table call with the scales given, the one-leaf call (a table of one)
    with torch.amax scales and the plain version bit for bit (a NaN row
    NaN in all)."""
    need_card()
    g = torch.Generator().manual_seed(4)
    shapes = [(1,), (3, 5, 7), (4097,), (8193,), (130,)] * 14
    vs = [torch.randn((8, *sh), generator=g).to("cuda", dtype)
          for sh in shapes]
    us = [torch.rand((8, *sh), generator=g).to("cuda", dtype)
          for sh in shapes]
    vs[0].zero_()
    vs[1][3, 0, 0, 0] = float("nan")
    vs[2][1, 0] = -0.0
    tree_v = {str(i): v for i, v in enumerate(vs)}
    tree_u = {str(i): u for i, u in enumerate(us)}
    ops.reset_launch_counts()
    q, r = ops.qsgd_compress_tree(tree_v, tree_u, 15)
    assert ops.launch_counts()["qsgd"] == 2
    scales = torch.cat([torch.amax(v.reshape(8, -1).abs(), dim=1).float()
                        for v in vs])
    q_given, r_given = CP.qsgd_leaves(vs, us, 15, scales=scales)
    for i, (v, u) in enumerate(zip(vs, us)):
        scale = torch.amax(v.reshape(8, -1).abs(), dim=1)
        for got, given, per_leaf, plain in zip(
                (q[str(i)], r[str(i)]), (q_given[i], r_given[i]),
                CP.qsgd(v, u, scale, 15), ref.qsgd_quantize(v, u, scale, 15)):
            for want in (given, per_leaf, plain):
                assert torch.equal(got.isnan(), want.isnan())
                assert torch.equal(got.nan_to_num(), want.nan_to_num())
    assert not q["0"].any() and not r["0"].any()
    assert q["1"][3].isnan().all() and not q["1"][:3].isnan().any()
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_engine_on_the_card_matches_the_cpu():
    """A reduced hybrid (Mamba2 and shared attention) served on the card
    and on the CPU from the same parameters: the prefill step's kernel
    route launches one SSD scan per Mamba2 block and one flash attention
    per shared-attention block, and both engines give the same greedy
    tokens (TF32 off)."""
    need_card()
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MAMBA2, SHARED_ATTN
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models import transformer as LM
    from repro_torch.serving import SchedulerConfig, ServingEngine
    cfg = replace(get_arch("zamba2-1.2b").reduced(),
                  block_pattern=(MAMBA2, MAMBA2, SHARED_ATTN, MAMBA2,
                                 SHARED_ATTN))
    params = LM.init(0, cfg, device="cpu")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = T.tree_map(lambda t: t.cuda(), params)
        tokens = torch.randint(0, cfg.vocab_size, (2, 96),
                               generator=torch.Generator().manual_seed(7))
        ops.reset_launch_counts()
        first = make_prefill_step(cfg, True)(card, {"tokens": tokens.cuda()})
        counts = ops.launch_counts()
        assert counts["ssd_scan"] == 3 and counts["flash_attention"] == 2
        assert torch.equal(first.cpu(), make_prefill_step(cfg, True)(
            params, {"tokens": tokens}))
        outs = []
        for device, p in (("cuda", card), ("cpu", params)):
            eng = ServingEngine(cfg, p, SchedulerConfig(
                n_slots=2, max_len=64, prefill_chunk=8, page_size=16),
                device=device)
            for i in range(3):
                eng.add_request(tokens[i % 2, :10 + 5 * i].tolist(), 6)
            outs.append([o.tokens for o in eng.run()])
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    assert outs[0] == outs[1]


@pytest.mark.gpu
def test_lm_kernels_refuse_a_gradient_on_the_card():
    """Neither LM kernel has a backward (nor has the reference's Pallas
    kernel): on the card ``loss_fn(use_pallas=True)`` with parameters that
    require grad raises instead of giving no gradient through attention
    and the SSD, and ``use_pallas=False`` gives every leaf a gradient; the
    kernel route runs under no_grad."""
    need_card()
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MAMBA2, SHARED_ATTN
    from repro_torch.models import transformer as LM
    cfg = replace(get_arch("zamba2-1.2b").reduced(),
                  block_pattern=(MAMBA2, SHARED_ATTN, MAMBA2))
    params = T.tree_map(lambda t: t.requires_grad_(),
                        LM.init(0, cfg, device="cuda"))
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator().manual_seed(3)).cuda()
    batch = {"tokens": toks, "labels": toks}
    with pytest.raises(RuntimeError, match="no backward"):
        LM.loss_fn(params, batch, cfg, use_pallas=True)[0].backward()
    loss, _ = LM.loss_fn(params, batch, cfg, use_pallas=False)
    loss.backward()
    grads = [t.grad for t in T.leaves(params["shared_attn"]["attn"])]
    assert grads and all(g is not None and torch.isfinite(g).all()
                         for g in grads)
    assert all(g.abs().sum() > 0 for g in grads)
    with torch.no_grad():
        ops.reset_launch_counts()
        kernel_loss = LM.loss_fn(params, batch, cfg, use_pallas=True)[0]
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["ssd_scan"] == 2
    assert abs(kernel_loss.item() - loss.item()) <= 1e-4 * abs(loss.item())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_reduce_leaves_over_the_models_leaves(dtype):
    """One call over the paper CNN's 16 leaves and over ResNet-18's 76
    (two leaf-table groups), stacked over K=8: each leaf bit for bit the
    plain version, one launch per 64 leaves."""
    need_card()
    from repro_torch.models.vision import cnn_init, resnet18_init
    g = torch.Generator().manual_seed(10)
    w = torch.rand(8, generator=g).cuda()
    for params in (cnn_init(0, width=32, image_size=32, device="cpu"),
                   resnet18_init(0, n_classes=100, device="cpu")):
        stacks = [torch.randn((8,) + tuple(t.shape), generator=g).to(
            "cuda", dtype) for t in T.leaves(params)]
        ops.reset_launch_counts()
        got = WR.weighted_reduce_leaves(stacks, w)
        assert ops.launch_counts()["weighted_reduce"] == -(-len(stacks)
                                                            // 64)
        for o, d in zip(got, stacks):
            assert o.shape == d.shape[1:] and o.dtype == dtype
            assert torch.equal(o, ref.weighted_delta_reduce(d, w))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_flash_attention_bf16_at_the_smoke_shapes():
    """The tensor-core bf16 kernel at every shape ``chip_smoke.py`` checks
    (the reference sweep, its windows, zamba2-1.2b's prefill and Qwen3's
    GQA 32/8 at D 128) within the reference's bf16 bar, 2e-2 abs + rel."""
    need_card()
    from repro_torch.kernels import flash_attention as FA
    g = torch.Generator().manual_seed(12)
    for B, H, Hk, L, D, window in ((1, 2, 2, 128, 64, 0),
                                   (2, 4, 2, 256, 64, 0),
                                   (1, 8, 1, 128, 128, 0),
                                   (1, 4, 4, 192, 64, 0),
                                   (1, 2, 2, 256, 64, 32),
                                   (1, 2, 2, 256, 64, 64),
                                   (1, 2, 2, 256, 64, 128),
                                   (4, 32, 32, 2048, 64, 0),
                                   (1, 32, 8, 1024, 128, 0)):
        q = torch.randn(B, L, H, D, generator=g).to("cuda", torch.bfloat16)
        k, v = (torch.randn(B, L, Hk, D, generator=g).to("cuda",
                                                          torch.bfloat16)
                for _ in range(2))
        got = FA.flash_attention(q, k, v, True, window)
        want = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), True,
                                   window).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_select_table_matches_plain(dtype):
    """The threshold select over a leaf table equals the per-leaf plain
    version bit for bit over the CNN's 16 leaves, ResNet-18's 76 (two
    groups), 65 leaves and an edge sweep (an empty leaf, a scalar, lengths
    off the 4096 tile and off the 16-byte word, a leaf one element past an
    aligned start: the one-at-a-time path), stacked over 8 clients; the tree
    form launches once a group of 64 leaves, and the one-leaf form (a table
    of one) agrees."""
    need_card()
    from repro_torch.models.vision import cnn_init, resnet18_init
    g = torch.Generator().manual_seed(13)
    sweeps = {
        "cnn": [tuple(t.shape) for t in T.leaves(cnn_init(
            0, width=32, image_size=32, device="cpu"))],
        "resnet18": [tuple(t.shape) for t in T.leaves(resnet18_init(
            0, n_classes=100, device="cpu"))],
        "65 leaves": [(1 + 37 * i,) for i in range(65)],
        "edge": [(0,), (), (1,), (3, 5, 7), (4095,), (4096,), (4097,),
                 (8193,), (13,)]}
    for tag, shapes in sweeps.items():
        vs = [torch.randn((8, *sh), generator=g).to("cuda", dtype)
              for sh in shapes]
        if tag == "edge":   # a view one element past an aligned start
            vs.append(torch.randn(8 * 4097 + 1, generator=g).to(
                "cuda", dtype)[1:].view(8, 4097))
        taus = [torch.topk(v.reshape(8, -1).abs(), max(1, v[0].numel() // 10),
                           dim=1).values[:, -1].contiguous()
                if v[0].numel() else torch.zeros(8, device="cuda",
                                                 dtype=dtype)
                for v in vs]
        ops.reset_launch_counts()
        q, r = ops.topk_compress_tree({str(i): v for i, v in enumerate(vs)},
                                      {str(i): t for i, t in enumerate(taus)})
        assert ops.launch_counts()["threshold_select"] == -(-len(vs) // 64)
        for i, (v, t) in enumerate(zip(vs, taus)):
            want_q, want_r = ref.topk_threshold_select(v, t)
            assert torch.equal(q[str(i)], want_q)
            assert torch.equal(r[str(i)], want_r)
            if v.is_contiguous():
                one_q, one_r = CP.threshold_select(v, t)
                assert torch.equal(one_q, want_q) and torch.equal(one_r, want_r)
    torch.cuda.synchronize()


def kd_close(got, want):
    """NaN and ±inf where the other has them, finite entries within the
    reference's bar (atol 1e-5, rtol 1e-4)."""
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        assert torch.equal(a.isnan(), b.isnan())
        inf = b.isinf()
        assert torch.equal(a[inf], b[inf])
        fin = torch.isfinite(b)
        torch.testing.assert_close(a[fin], b[fin], atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kd_forward_at_route_boundaries(dtype):
    """The one-read KD forward at each route's boundary, G > 1: the
    register route's cap and one more (a cluster of one CTA), the largest C
    one CTA stages and one more (a cluster of two), against the plain
    version within the reference's bar, the backward on its statistics
    within 1e-5 of the gradient's largest magnitude.  Then rows with a label
    out of range (NaN loss, CE, KL, true mass and S) and ±inf logits, one
    of them -inf on a whole lane's or the first CTA's classes: NaN and inf
    where the plain version has them (its one-hot product gives CE NaN
    where a student logit is infinite; there CE = lse_s - s_y)."""
    need_card()
    g = torch.Generator().manual_seed(14)
    esize = torch.empty((), dtype=dtype).element_size()
    single = KD.SLICE_BYTES // (2 * esize)
    for rows, C, groups in ((64, KD.WARP_MAX_C, 4), (64, KD.WARP_MAX_C + 1, 4),
                            (16, single, 2), (16, single + 1, 2)):
        s, t = ((2 * torch.randn(rows, C, generator=g)).to("cuda", dtype)
                for _ in range(2))
        y = torch.randint(0, C, (rows,), generator=g).cuda()
        rho = torch.rand(groups, C, generator=g).cuda()
        rho[:, 0] = 1.0
        got = KD.kd_loss(s, t, y, rho, 0.35, 2.0)
        kd_close(got, ref.kd_loss(s, t, y, rho, 0.35, 2.0))
        up = torch.rand(rows, generator=g).cuda()
        ds = KD.kd_loss_bwd(s, t, y, rho, got[3], up, 0.35, 2.0)
        ds_plain = ref.kd_loss_bwd(s, t, y, rho, got[3], up, 0.35, 2.0)
        err = (ds.float() - ds_plain.float()).abs().max()
        assert err <= 1e-5 * ds_plain.float().abs().max()
    for C in (10, KD.WARP_MAX_C, KD.WARP_MAX_C + 1, single + 1):
        s, t = ((2 * torch.randn(8, C, generator=g)).to("cuda", dtype)
                for _ in range(2))
        y = torch.randint(0, C, (8,), generator=g).cuda()
        rho = torch.rand(2, C, generator=g).cuda()
        j = torch.arange(C, device="cuda")
        cl, slice_, _ = KD.cluster_plan(C, esize)
        dead = (j < C // 2 if C <= 32 else j % 32 < 16 if C <= KD.WARP_MAX_C
                else j < (slice_ if cl > 1 else C // 2))
        y[0], y[2], y[3], y[4] = C, 0, C - 1, C - 1
        t[1, dead] = float("-inf")
        t[2, 3], t[2, 5] = float("inf"), float("-inf")
        s[3, dead] = float("-inf")
        s[4, 1] = float("inf")
        got = KD.kd_loss(s, t, y, rho, 0.35, 1.0)
        want = [w.clone() for w in ref.kd_loss(s, t, y, rho, 0.35, 1.0)]
        for r in (3, 4):
            want[1][r] = want[3][r, 0] - s[r, y[r]].float()
            want[0][r] = 0.65 * want[1][r] + 0.35 * want[2][r]
        for w in want[:3]:
            w[0] = float("nan")
        want[3][0, 3:] = float("nan")
        kd_close(got, want)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_async_engine_on_the_card_matches_the_cpu():
    """The semi-async engine on the card (TF32 off) against the CPU from the
    same parameters and seeds: the event log and the bytes equal (they
    depend only on numpy draws), the parameters within the one-step bar
    1e-4 of the update (one local step a client, drops folded back into
    the EF residuals, three buffered-2 flushes)."""
    need_card()
    from repro_torch.configs.base import HeteroConfig
    from repro_torch.federated.async_engine import AsyncFederatedSimulator
    from repro_torch.models.vision import cnn_init
    x, y, xt, yt = make_image_dataset(400, 50, 10, image_size=16)
    parts = sort_and_partition(y, 10, s=2)
    params0 = cnn_init(5, width=8, image_size=16, device="cpu")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        engines = []
        for device in ("cuda", "cpu"):
            e = AsyncFederatedSimulator(
                FedConfig(local_steps=1, clients_per_round=4, n_clients=10,
                          eta=0.01, buffer_k=2, compressor="topk",
                          topk_frac=0.1),
                SimConfig(batch_size=16, cnn_width=8, rounds=3, seed=5),
                HeteroConfig(enabled=True, speed_dist="bimodal",
                             drop_prob=0.3, seed=2),
                x, y, xt, yt, parts, device=device,
                params=T.tree_map(lambda t: t.clone(), params0))
            e.run()
            engines.append(e)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    card, cpu = engines
    assert list(card.event_log) == list(cpu.event_log)
    assert any(ev[0] == "drop" for ev in cpu.event_log)
    assert (card.uplink_bytes, card.downlink_bytes) == (cpu.uplink_bytes,
                                                        cpu.downlink_bytes)
    num = sum(((a.cpu() - b) ** 2).sum()
              for a, b in zip(T.leaves(card.params), T.leaves(cpu.params)))
    den = sum(((b - p) ** 2).sum()
              for b, p in zip(T.leaves(cpu.params), T.leaves(params0)))
    assert (num / den).sqrt().item() <= 1e-4


@pytest.mark.gpu
def test_fleet_and_checkpoints_on_the_card(tmp_path):
    """One region is bit for bit the flat aggregate on the card, dense and
    sparse; paged pages and checkpoints of card tensors round-trip bit for
    bit in fp32, bf16 and fp8."""
    need_card()
    from repro_torch.checkpointing.checkpoint import (restore_checkpoint,
                                                      save_checkpoint,
                                                      storage_view)
    from repro_torch.federated.compression import SparseLeaf
    from repro_torch.federated.fleet import PagedClientStore, page_nbytes
    from repro_torch.federated.protocol import RoundProtocol

    def same(a, b):
        return all(storage_view(u).tobytes() == storage_view(v).tobytes()
                   for u, v in zip(T.leaves(a), T.leaves(b)))
    g = torch.Generator().manual_seed(0)
    like = {"w": torch.zeros(37, 29, device="cuda"),
            "b": torch.zeros(300, device="cuda")}
    dense = {k: torch.randn((6,) + v.shape, generator=g).cuda()
             for k, v in like.items()}
    sparse = {k: SparseLeaf(torch.randn(6, 9, generator=g).cuda(),
                            torch.stack([torch.randperm(v.numel(),
                                                        generator=g)[:9]
                                         for _ in range(6)])
                            .to("cuda", torch.int32))
              for k, v in like.items()}
    w = torch.rand(6, generator=g).cuda()
    for deltas in (dense, sparse):
        flat, hier = (RoundProtocol(FedConfig(fleet_regions=r,
                                              clients_per_round=6))
                      .aggregate(deltas, w, like=like) for r in (0, 1))
        assert same(flat, hier)
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
               torch.float8_e5m2):
        page = {k: v.to(dt) for k, v in like.items()}
        store = PagedClientStore(budget_bytes=page_nbytes(page))
        store.register("p", lambda page=page: T.zeros_like(page))
        stacked = {k: torch.randn((3,) + v.shape, generator=g).cuda().to(dt)
                   for k, v in like.items()}
        store.scatter("p", [0, 1, 2], stacked)
        assert store.spilled_pages == 2
        got = store.gather("p", [0, 1, 2])
        assert got["w"].is_cuda and same(got, stacked)
        save_checkpoint(str(tmp_path), 0, stacked)
        back = restore_checkpoint(str(tmp_path), 0, stacked)
        assert back["w"].is_cuda and same(back, stacked)
