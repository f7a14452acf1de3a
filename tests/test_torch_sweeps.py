"""The sweep forms of the port's update and wire kernels: one call over
every leaf of a tree, described to the card by a leaf table.

On the CPU the tree forms (``ops.fused_axpy_tree``,
``ops.weighted_delta_reduce_tree``,
``ops.sparse_weighted_delta_reduce_tree``) run the same per-leaf plain
versions as the one-leaf forms, so they are held bit for bit against
those, the dense reduce also against the JAX package's
``weighted_delta_reduce`` (at ``test_torch_kernels.py``'s bar) and the
sparse one against its ``sparse_weighted_delta_reduce`` (client-major,
pair-order fp32 sums on both sides).  The packer of the leaf table is pure Python, so its layout
and its split into groups of 64 leaves are checked here with CPU
``data_ptr()``s; the kernels that read the table need the card
(``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import strategies as S
from repro_torch.core import tree as T
from repro_torch.kernels import compress as CP
from repro_torch.kernels import fedadc_update as FU
from repro_torch.kernels import leaf_table as LT
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_reduce as SR
from repro_torch.kernels import weighted_reduce as WR
from repro_torch.models.vision import cnn_init

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# mixed shapes: a conv kernel, a bias, a scalar, an empty leaf, a ragged
# length, stacked over K=3 clients
SHAPES = {"c1": {"w": (3, 3, 3, 5), "b": (5,)}, "s": (), "e": (0, 4),
          "d": {"w": (37, 11), "b": (11,)}}


def stacked_tree(seed, dtype, k=3):
    """A tree of SHAPES stacked over k clients (T.tree_map recurses into
    dicts only, so the shape tuples are its leaves)."""
    rng = np.random.RandomState(seed)
    return T.tree_map(
        lambda s: torch.from_numpy(rng.randn(k, *s).astype(np.float32)
                                   ).to(dtype), SHAPES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_axpy_tree_equals_per_leaf_plain(dtype):
    dt = DTYPES[dtype]
    xs, ys = stacked_tree(0, dt), stacked_tree(1, dt)
    ops.reset_launch_counts()
    got = ops.fused_axpy_tree(xs, ys, -0.05)
    assert ops.launch_counts()["fused_axpy"] == 0
    for g, x, y in zip(T.leaves(got), T.leaves(xs), T.leaves(ys)):
        assert g.dtype == dt and g.shape == x.shape
        assert torch.equal(g, ref.fused_axpy(x, y, -0.05))
    assert list(got) == list(xs) and list(got["c1"]) == ["w", "b"]


def test_fused_axpy_tree_mixed_dtypes_cast_y_and_keep_x_dtype():
    xs = {"a": torch.randn(4, 7), "b": torch.randn(4, 3).bfloat16()}
    ys = {"a": torch.randn(4, 7).bfloat16(), "b": torch.randn(4, 3)}
    got = ops.fused_axpy_tree(xs, ys, 0.5)
    for key in xs:
        assert got[key].dtype == xs[key].dtype
        assert torch.equal(got[key], ops.fused_axpy(xs[key], ys[key], 0.5))


def test_sweeps_refuse_mixed_devices():
    xs = {"a": torch.randn(3), "b": torch.randn(3, device="meta")}
    with pytest.raises(ValueError, match="mixed devices"):
        ops.fused_axpy_tree(xs, xs, 0.5)
    with pytest.raises(ValueError, match="mixed devices"):
        ops.sparse_weighted_delta_reduce_tree(
            {"a": torch.randn(2, 3)},
            {"a": torch.zeros((2, 3), dtype=torch.int32)},
            torch.ones(2, device="meta"), {"a": torch.zeros(8)})


def test_sgd_step_runs_the_tree_form():
    """The SGD step (and so the nesterov half-step's kernel) equals the
    per-leaf axpy θ − η·g bit for bit."""
    from repro_torch.configs.base import FedConfig
    theta, g = stacked_tree(2, torch.float32), stacked_tree(3, torch.float32)
    got = S._sgd_step(theta, g, 0.05, FedConfig())
    for a, t, gi in zip(T.leaves(got), T.leaves(theta), T.leaves(g)):
        assert torch.equal(a, ref.fused_axpy(t, gi, -0.05))


def sparse_wire(seed, K, shapes, k_frac=0.3, dup=True, dtype=torch.float32):
    """Per leaf (values (K, k), indices (K, k) int32): random indices with
    duplicates within and across clients when ``dup``, else unique."""
    rng = np.random.RandomState(seed)
    vals, idxs = {}, {}
    for name, shape in shapes.items():
        n = int(np.prod(shape)) if shape else 1
        k = max(1, int(k_frac * n)) if n else 0
        vals[name] = torch.from_numpy(rng.randn(K, k).astype(np.float32)
                                      ).to(dtype)
        if dup:
            idx = rng.randint(0, max(n, 1), (K, k))
        else:
            idx = np.stack([rng.choice(n, size=k, replace=False)
                            for _ in range(K)])
        idxs[name] = torch.from_numpy(idx.astype(np.int32))
    return vals, idxs


SPARSE_SHAPES = {"w": (64, 32), "b": (17,), "s": (), "r": (9001,)}


@pytest.mark.parametrize("vdt,odt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
@pytest.mark.parametrize("dup", [True, False])
def test_sparse_tree_matches_jax_reference(vdt, odt, dup):
    """Duplicates within and across clients (``dup``) or top-k-like unique
    indices: every leaf of the sweep equals the JAX package's
    ``sparse_weighted_delta_reduce`` and the port's per-leaf plain
    version bit for bit."""
    K = 5
    vals, idxs = sparse_wire(4 if dup else 5, K, SPARSE_SHAPES, dup=dup,
                             dtype=DTYPES[vdt])
    w = torch.from_numpy(np.random.RandomState(6).uniform(0.2, 1.0, K)
                         .astype(np.float32))
    like = {n: torch.zeros(s, dtype=DTYPES[odt])
            for n, s in SPARSE_SHAPES.items()}
    got = ops.sparse_weighted_delta_reduce_tree(vals, idxs, w, like)
    for name, shape in SPARSE_SHAPES.items():
        assert got[name].shape == shape and got[name].dtype == DTYPES[odt]
        plain = ops.sparse_weighted_delta_reduce(vals[name], idxs[name], w,
                                                 shape, DTYPES[odt])
        assert torch.equal(got[name], plain)
        want = jref.sparse_weighted_delta_reduce(
            jnp.asarray(vals[name].float().numpy(), JAX_DT[DTYPES[vdt]]),
            jnp.asarray(idxs[name].numpy()), jnp.asarray(w.numpy()), shape,
            JAX_DT[DTYPES[odt]])
        np.testing.assert_array_equal(
            got[name].float().numpy(),
            np.asarray(jnp.asarray(want).astype(jnp.float32)))


def test_sparse_tree_drops_out_of_range_indices():
    """Indices below 0 or at n and above add nothing, in the sweep, in the
    per-leaf plain version and in the reference's ``segment_sum``; an empty
    wire (k = 0) gives zeros."""
    K = 3
    vals, idxs = sparse_wire(8, K, {"a": (40,), "b": (7, 3)})
    idxs["a"][0, :4] = torch.tensor([-1, 40, 1000, -77], dtype=torch.int32)
    idxs["b"][2, -2:] = torch.tensor([21, -21], dtype=torch.int32)
    vals["z"] = torch.zeros((K, 0))
    idxs["z"] = torch.zeros((K, 0), dtype=torch.int32)
    shapes = {"a": (40,), "b": (7, 3), "z": (6,)}
    w = torch.tensor([0.5, 0.25, 1.0])
    like = {n: torch.zeros(s) for n, s in shapes.items()}
    got = ops.sparse_weighted_delta_reduce_tree(vals, idxs, w, like)
    assert torch.equal(got["z"], torch.zeros(6))
    for name in ("a", "b"):
        plain = ref.sparse_weighted_delta_reduce(vals[name], idxs[name], w,
                                                 shapes[name], torch.float32)
        assert torch.equal(got[name], plain)
        want = jref.sparse_weighted_delta_reduce(
            jnp.asarray(vals[name].numpy()), jnp.asarray(idxs[name].numpy()),
            jnp.asarray(w.numpy()), shapes[name], jnp.float32)
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want))
    keep = (idxs["a"] >= 0) & (idxs["a"] < 40)
    manual = torch.zeros(40).index_add_(
        0, idxs["a"][keep].long(), (w[:, None] * vals["a"])[keep])
    torch.testing.assert_close(got["a"], manual, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the leaf-table packer
# ---------------------------------------------------------------------------
def test_pack_lays_out_fields_then_inclusive_ends():
    xs = [torch.randn(n) for n in (5000, 0, 2048, 1)]
    ys = [torch.randn(n) for n in (5000, 0, 2048, 1)]
    fields = [(x.data_ptr(), y.data_ptr(), 4096 * i, x.numel())
              for i, (x, y) in enumerate(zip(xs, ys))]
    units = [(LT.cdiv(x.numel(), 2048), x.numel()) for x in xs]
    rows, totals = LT.pack(fields, units)
    assert rows.shape == (4, 6) and rows.dtype.name == "int64"
    ends = [(3, 5000), (3, 5000), (4, 7048), (5, 7049)]
    for row, f, e in zip(rows.tolist(), fields, ends):
        assert row == list(f) + list(e)
    assert totals == [(5, 7049)]


@pytest.mark.parametrize("n_leaves,capacity", [(64, 64), (65, 64), (76, 64),
                                               (130, 64), (7, 3)])
def test_pack_splits_above_capacity_and_restarts_the_ends(n_leaves,
                                                          capacity):
    fields = [(i, 10 * i) for i in range(n_leaves)]
    units = [(i % 4,) for i in range(n_leaves)]
    rows, totals = LT.pack(fields, units, capacity)
    assert rows.shape == (n_leaves, 3)
    assert len(totals) == -(-n_leaves // capacity)
    run = 0
    for i, row in enumerate(rows.tolist()):
        if i % capacity == 0:
            run = 0
        run += i % 4
        assert row == [i, 10 * i, run]
    for g, tot in enumerate(totals):
        group = range(g * capacity, min(n_leaves, (g + 1) * capacity))
        assert tot == (sum(i % 4 for i in group),)


def test_pack_empty_and_padding():
    rows, totals = LT.pack([], [])
    assert rows.size == 0 and totals == []
    assert [LT.padded(n) for n in (0, 1, 8, 9, 4097)] == [0, 8, 8, 16, 4104]


def test_sweep_wrappers_refuse_cpu_and_unsupported_operands():
    """The kernels' own wrappers never compute on the CPU: a CPU tensor, an
    unsupported dtype or a mismatched pair raises before any launch."""
    x = torch.randn(8, 10)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        FU.fused_axpy_leaves([x, x], [x, x], 0.5)
    with pytest.raises(ValueError, match="not supported"):
        FU.fused_axpy_leaves([x.double()], [x.double()], 0.5)
    with pytest.raises(ValueError, match="leaves"):
        FU.fused_axpy_leaves([x], [], 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        SR.sparse_reduce_leaves([x], [x.int()], torch.ones(8), [(10,)],
                                torch.float32)
    with pytest.raises(ValueError, match="not supported"):
        SR.sparse_reduce_leaves([x], [x.int()], torch.ones(8), [(10,)],
                                torch.float64)
    assert FU.fused_axpy_leaves([], [], 0.5) == []
    assert SR.sparse_reduce_leaves([], [], torch.ones(8), [],
                                   torch.float32) == []
    assert ops.launch_counts()["fused_axpy"] == 0
    assert ops.launch_counts()["sparse_reduce"] == 0


# ---------------------------------------------------------------------------
# the dense aggregate: the weighted reduce over every leaf
# ---------------------------------------------------------------------------
def bf16_ulp(v):
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_reduce_tree_matches_plain_and_reference(dtype):
    """Over the paper CNN's 16 leaf shapes (width 32) stacked over K=8
    clients: bit for bit the per-leaf plain version, and within
    ``test_torch_kernels.py``'s bar of the JAX package's Pallas reduce
    (1e-6 of Σ|w·Δ| in fp32; one bf16 ulp in bf16, where the reference
    rounds each op)."""
    dt = DTYPES[dtype]
    shapes = [tuple(t.shape) for t in T.leaves(
        cnn_init(0, width=32, image_size=32, device="cpu"))]
    assert len(shapes) == 16
    rng = np.random.RandomState(11)
    tree = {f"l{i:02d}": torch.from_numpy(
        rng.randn(8, *sh).astype(np.float32)).to(dt)
        for i, sh in enumerate(shapes)}
    w = torch.from_numpy(rng.uniform(0.2, 1.0, 8).astype(np.float32))
    ops.reset_launch_counts()
    got = ops.weighted_delta_reduce_tree(tree, w)
    assert ops.launch_counts()["weighted_reduce"] == 0
    assert list(got) == list(tree)
    want = jops.weighted_delta_reduce(
        {k: jnp.asarray(d.float().numpy(), JAX_DT[dt])
         for k, d in tree.items()}, jnp.asarray(w.numpy()))
    for key, d in tree.items():
        assert got[key].dtype == dt and got[key].shape == d.shape[1:]
        assert torch.equal(got[key], ref.weighted_delta_reduce(d, w))
        g = got[key].double().numpy()
        jw = np.asarray(jnp.asarray(want[key]).astype(jnp.float32),
                        np.float64)
        terms = np.sum(np.abs(w.double().numpy().reshape(
            (8,) + (1,) * (d.dim() - 1)) * d.double().numpy()), axis=0)
        bound = 1e-6 * terms if dtype == "float32" else bf16_ulp(
            np.maximum(np.abs(jw), terms))
        assert np.all(np.abs(g - jw) <= bound)


def test_weighted_mean_runs_the_tree_form():
    """``aggregation.weighted_mean`` normalises the weights and reduces
    every leaf through the tree form, mixed dtypes included."""
    from repro_torch.federated import aggregation as A
    tree = {"a": torch.randn(3, 4, 5), "b": {"c": torch.randn(3, 7).bfloat16()}}
    w = torch.tensor([1.0, 2.0, 5.0])
    got = A.weighted_mean(tree, w)
    wn = w / w.sum()
    assert torch.equal(got["a"], ref.weighted_delta_reduce(tree["a"], wn))
    assert torch.equal(got["b"]["c"],
                       ref.weighted_delta_reduce(tree["b"]["c"], wn))
    assert got["b"]["c"].dtype == torch.bfloat16


@pytest.mark.parametrize("n_leaves", [16, 64, 65, 76])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_reduce_plan(n_leaves, dtype):
    """The reduce's table: per leaf (stack pointer, 0, the output's byte
    offset, n, end of its blocks of 4 KB of output); offsets 16-byte
    aligned; one launch per 64 leaves; views that tile the buffer."""
    lengths = [1, 7, 1024, 1025, 4097, 0, 2048, 30]
    shapes = tuple((lengths[i % len(lengths)],) for i in range(n_leaves))
    tile = WR.REDUCE_BYTES // torch.empty((), dtype=dtype).element_size()
    rows, total, views, launches = FU._sweep_plan(shapes, dtype, tile)
    assert rows.shape == (n_leaves, 5)
    esize = torch.empty((), dtype=dtype).element_size()
    run, off = 0, 0
    for i, ((n,), row) in enumerate(zip(shapes, rows.tolist())):
        if i % LT.MAX_LEAVES == 0:
            run = 0
        run += LT.cdiv(n, tile)
        assert row == [0, 0, off * esize, n, run]
        assert row[2] % 16 == 0
        assert views[i] == ((n,), (1,), off)
        off += LT.padded(n)
    assert total == off
    assert launches == -(-n_leaves // LT.MAX_LEAVES)


@pytest.mark.parametrize("n_leaves", [16, 64, 70])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qsgd_plan(n_leaves, dtype):
    """QSGD's table: per leaf (v, u, q's and r's byte offsets, n, end of its
    rows, end of its blocks: rows x tiles of 4096 elements), the ends
    restarting every 64 leaves; q's of every leaf then r's in one buffer,
    16-byte aligned; one launch per group that has a block."""
    lengths = [1, 7, 4096, 4097, 0, 8193, 30]
    shapes = tuple((3 + i % 2, lengths[i % len(lengths)])
                   for i in range(n_leaves))
    rows, half, views, totals = CP._qsgd_plan(shapes, dtype)
    assert rows.shape == (n_leaves, 7)
    esize = torch.empty((), dtype=dtype).element_size()
    off, run_rows, run_blocks = 0, 0, 0
    for i, (shape, row) in enumerate(zip(shapes, rows.tolist())):
        if i % LT.MAX_LEAVES == 0:
            run_rows = run_blocks = 0
        k, n = shape
        run_rows += k
        run_blocks += k * LT.cdiv(n, CP.QSGD_TILE)
        assert row == [0, 0, off * esize, (half + off) * esize, n, run_rows,
                       run_blocks]
        assert row[2] % 16 == 0 and row[3] % 16 == 0
        assert views[i] == (shape, (n, 1), off)
        off += LT.padded(k * n)
    assert half == off
    assert len(totals) == LT.cdiv(n_leaves, LT.MAX_LEAVES)
    assert sum(t[0] for t in totals) == sum(k for k, _ in shapes)


def test_qsgd_tree_refuses_cpu_leaves_and_mixed_devices():
    """The table wrapper takes CUDA leaves only; the tree form keeps CPU
    leaves on the plain version and refuses a sweep over two devices."""
    v = torch.randn(4, 10)
    with pytest.raises(ValueError, match="CUDA"):
        CP.qsgd_leaves([v], [v], 15)
    assert CP.qsgd_leaves([], [], 15) == ([], [])
    with pytest.raises(ValueError, match="not supported"):
        CP.qsgd_leaves([v.double()], [v.double()], 15)
    with pytest.raises(ValueError, match="mixed devices"):
        ops.qsgd_compress_tree({"a": v}, {"a": torch.rand(4, 10,
                                                           device="meta")}, 15)


def test_weighted_reduce_wrapper_refuses_cpu_and_bad_stacks():
    x = torch.randn(4, 10)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        WR.weighted_reduce_leaves([x, x], torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        WR.weighted_reduce(x, torch.ones(4))
    with pytest.raises(ValueError, match="not supported"):
        WR.weighted_reduce_leaves([x.double()], torch.ones(4))
    assert WR.weighted_reduce_leaves([], torch.ones(4)) == []
    assert ops.launch_counts()["weighted_reduce"] == 0
    with pytest.raises(ValueError, match="mixed devices"):
        ops.weighted_delta_reduce_tree({"a": x}, torch.ones(4, device="meta"))
