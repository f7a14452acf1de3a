"""The FedADC local and server steps over whole trees: one call a sweep,
described to the card by the update leaf table (``csrc/leaf_table.cuh``).

On the CPU the tree forms (``ops.fedadc_local_update_tree``,
``ops.fedadc_server_update_tree``) run the per-leaf plain versions, so
they are held bit for bit against those, the server step also against the
path it replaced (Δ̄ = mean_delta/η formed by its own sweep, then the
server update), and within ``test_torch_kernels.py``'s bars against the
JAX package's ``fedadc_local_update`` / ``fedadc_server_update`` (the
Pallas kernels in interpret mode) and their jnp oracles.  The table's
layout is pure Python and checked here; the kernels that read it need the
card (``tests/test_torch_gpu.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.base import FedConfig
from repro_torch.core import strategies as S
from repro_torch.core import tree as T
from repro_torch.kernels import fedadc_update as FU
from repro_torch.kernels import leaf_table as LT
from repro_torch.kernels import ops, ref

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# a conv kernel, a bias, a scalar, an empty leaf, lengths off the 2048 tile
SHAPES = {"c1": {"w": (3, 3, 3, 5), "b": (5,)}, "s": (), "e": (0, 4),
          "d": {"w": (37, 61), "b": (2049,)}}
# the reference's Pallas wrapper cannot tile an empty leaf (its grid
# divides by the rows), so the comparisons with it leave that leaf out
JAX_SHAPES = {k: v for k, v in SHAPES.items() if k != "e"}
ETA, GAMMA, ALPHA_ETA = 0.03, 0.7, 0.05


def tree(seed, dtype, k=None, shapes=SHAPES):
    """A tree of ``shapes`` (stacked over k clients where given) from
    numpy."""
    rng = np.random.RandomState(seed)
    lead = () if k is None else (k,)
    return T.tree_map(
        lambda s: torch.from_numpy(np.asarray(rng.randn(*lead, *s),
                                              np.float32)).to(dtype), shapes)


def bf16_ulp(v):
    v = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def assert_close(got, want, terms, dtype):
    """``test_torch_kernels.py``'s bars: 1e-6 of the terms in fp32, one bf16
    ulp of the larger of result and terms in bf16."""
    got = got.double().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    bound = (1e-6 * terms if dtype is torch.float32
             else bf16_ulp(np.maximum(np.abs(want), terms)))
    assert np.all(np.abs(got - want) <= bound), np.max(np.abs(got - want))


def jx(t):
    return jnp.asarray(t.float().numpy(), JAX_DT[t.dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_update_tree_equals_per_leaf_plain(dtype):
    """Over client-stacked leaves: bit for bit the per-leaf plain version,
    no launch on the CPU, the tree's structure kept; g and m̄ in another
    dtype are cast to θ's first, as the one-leaf form does."""
    dt = DTYPES[dtype]
    theta, g = tree(0, dt, k=3), tree(1, torch.float32, k=3)
    m_bar = tree(2, dt, k=3)
    ops.reset_launch_counts()
    got = ops.fedadc_local_update_tree(theta, g, m_bar, ETA)
    assert ops.launch_counts()["local_update"] == 0
    assert list(got) == list(theta) and list(got["d"]) == ["w", "b"]
    for o, t, gi, m in zip(T.leaves(got), T.leaves(theta), T.leaves(g),
                           T.leaves(m_bar)):
        assert o.dtype == dt and o.shape == t.shape
        assert torch.equal(o, ref.fedadc_local_update(t, gi.to(dt), m, ETA))
        assert torch.equal(o, ops.fedadc_local_update(t, gi, m, ETA))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_server_update_tree_folds_the_scale_bit_for_bit(dtype):
    """θ in `dtype` beside the fp32 momentum, Δ = mean_delta in θ's dtype
    and scale 1/η: θ' and m' equal, bit for bit, the path the fold replaced
    (Δ̄ = fp32(Δ)·(1/η) as its own sweep, then the per-leaf server update)
    and the per-leaf plain version; θ' keeps θ's dtype, m' is fp32."""
    dt = DTYPES[dtype]
    theta, m, delta = tree(3, dt), tree(4, torch.float32), tree(5, dt)
    ops.reset_launch_counts()
    got_t, got_m = ops.fedadc_server_update_tree(theta, m, delta, GAMMA,
                                                 ALPHA_ETA, scale=1.0 / ETA)
    assert ops.launch_counts()["server_update"] == 0
    delta_bar = T.scale(T.cast(delta, torch.float32), 1.0 / ETA)
    for ot, om, t, mi, d, db in zip(
            T.leaves(got_t), T.leaves(got_m), T.leaves(theta), T.leaves(m),
            T.leaves(delta), T.leaves(delta_bar)):
        assert ot.dtype == dt and om.dtype == torch.float32
        assert ot.shape == om.shape == t.shape
        for want_t, want_m in (
                ops.fedadc_server_update(t, mi, db, GAMMA, ALPHA_ETA),
                ref.fedadc_server_update(t, mi, d, GAMMA, ALPHA_ETA,
                                         1.0 / ETA)):
            assert torch.equal(ot, want_t) and torch.equal(om, want_m)
    assert list(got_t) == list(theta) and list(got_m["c1"]) == ["w", "b"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_update_trees_match_jax_reference(dtype):
    """Within ``test_torch_kernels.py``'s bars: the local step against the
    JAX package's ``fedadc_local_update`` (its Pallas kernel in interpret
    mode) and jnp oracle; the server step with Δ̄ = Δ/η folded in against
    the jnp oracle on Δ̄ = Δ·(1/η) in fp32 (m' at the fp32 bar whatever θ's
    dtype), and against the Pallas kernel in fp32, whose wrapper casts m
    and Δ̄ to θ's dtype."""
    dt = DTYPES[dtype]
    theta, g, m_bar = (tree(seed, dt, k=3, shapes=JAX_SHAPES)
                       for seed in (6, 7, 8))
    got = ops.fedadc_local_update_tree(theta, g, m_bar, ETA)
    pal = jops.fedadc_local_update(T.tree_map(jx, theta), T.tree_map(jx, g),
                                   T.tree_map(jx, m_bar), ETA)
    def check_local(o, p, t, gi, mb):   # (JAX orders a dict's leaves by key)
        tn, gn, mn = (x.double().numpy() for x in (t, gi, mb))
        terms = np.abs(tn) + ETA * (np.abs(gn) + np.abs(mn))
        assert_close(o, p, terms, dt)
        assert_close(o, jref.fedadc_local_update(jx(t), jx(gi), jx(mb), ETA),
                     terms, dt)
    T.tree_map(check_local, got, pal, theta, g, m_bar)

    theta, m, delta = (tree(seed, d, shapes=JAX_SHAPES)
                       for seed, d in ((9, dt), (10, torch.float32), (11, dt)))
    got_t, got_m = ops.fedadc_server_update_tree(theta, m, delta, GAMMA,
                                                 ALPHA_ETA, scale=1.0 / ETA)
    for ot, om, t, mi, d in zip(T.leaves(got_t), T.leaves(got_m),
                                T.leaves(theta), T.leaves(m),
                                T.leaves(delta)):
        db = jnp.asarray(d.float().numpy()) * jnp.float32(1.0 / ETA)
        m_terms = np.abs(np.asarray(db, np.float64)) + GAMMA * np.abs(
            mi.double().numpy())
        t_terms = np.abs(t.double().numpy()) + ALPHA_ETA * m_terms
        ref_t, ref_m = jref.fedadc_server_update(
            jx(t), jnp.asarray(mi.numpy()), db, GAMMA, ALPHA_ETA)
        assert_close(om, ref_m, m_terms, torch.float32)
        assert_close(ot, ref_t.astype(JAX_DT[dt]), t_terms, dt)
        if dt is torch.float32:
            pal_t, pal_m = jops.fedadc_server_update(
                {"p": jx(t)}, {"p": jnp.asarray(mi.numpy())}, {"p": db},
                GAMMA, ALPHA_ETA)
            assert_close(ot, pal_t["p"], t_terms, dt)
            assert_close(om, pal_m["p"], m_terms, dt)


def test_strategies_run_the_update_trees():
    """FedADC's heavy-ball local step and the FedADC and SlowMo server
    steps go through the tree forms: bit for bit the per-leaf steps they
    replaced (clip and weight decay folded into g first; Δ̄ = mean_delta/η
    in fp32 as its own sweep, then the per-leaf server update)."""
    fed = FedConfig(variant="heavyball", eta=ETA, grad_clip=1.5,
                    weight_decay=1e-3)
    theta, m_bar = tree(12, torch.float32, k=3), tree(13, torch.float32, k=3)
    g = tree(14, torch.float32, k=3)
    got, _, aux = S.FedADC().local_step(theta, {"m_bar": m_bar},
                                        lambda t, b: (g, "aux"), None, fed,
                                        None)
    assert aux == "aux"
    gc = S._wd(theta, S._maybe_clip(g, fed), fed)
    for o, t, gi, m in zip(T.leaves(got), T.leaves(theta), T.leaves(gc),
                           T.leaves(m_bar)):
        assert torch.equal(o, ref.fedadc_local_update(t, gi, m, fed.eta))

    params, mean_delta = tree(15, torch.bfloat16), tree(16, torch.bfloat16)
    state = {"m": tree(17, torch.float32)}
    for strategy, gamma in ((S.FedADC(), fed.beta_global - fed.beta_local),
                            (S.SlowMo(), fed.beta_global)):
        theta_new, new_state = strategy.server_update(state, params,
                                                      mean_delta, fed)
        delta_bar = T.scale(T.cast(mean_delta, torch.float32), 1.0 / fed.eta)
        for ot, om, t, mi, db in zip(
                T.leaves(theta_new), T.leaves(new_state["m"]),
                T.leaves(params), T.leaves(state["m"]), T.leaves(delta_bar)):
            want_t, want_m = ref.fedadc_server_update(
                t, mi, db, gamma, fed.alpha * fed.eta)
            assert torch.equal(ot, want_t) and torch.equal(om, want_m)


@pytest.mark.parametrize("n_leaves", [1, 16, 64, 65, 76])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_plan(n_leaves, dtype):
    """The update table: per leaf (θ, g or m, m̄ or Δ, θ''s byte offset in
    the θ-dtype buffer, m''s in the fp32 buffer, n, end of its blocks of
    ``UPDATE_TILE`` elements), the ends restarting every 64 leaves; every
    offset 16-byte aligned; one launch per group that has a block; views
    that tile both buffers at one geometry."""
    lengths = [1, 7, 2047, 2048, 2049, 0, 4097, 30]
    shapes = tuple((lengths[i % len(lengths)],) for i in range(n_leaves))
    rows, total, views, launches = FU._sweep_plan(
        shapes, dtype, FU.UPDATE_TILE, inputs=3, fp32_output=True)
    assert rows.shape == (n_leaves, 7)
    esize = torch.empty((), dtype=dtype).element_size()
    run, off, groups = 0, 0, set()
    for i, ((n,), row) in enumerate(zip(shapes, rows.tolist())):
        if i % LT.MAX_LEAVES == 0:
            run = 0
        run += LT.cdiv(n, FU.UPDATE_TILE)
        if n:
            groups.add(i // LT.MAX_LEAVES)
        assert row == [0, 0, 0, off * esize, off * 4, n, run]
        assert row[3] % 16 == 0 and row[4] % 16 == 0
        assert views[i] == ((n,), (1,), off)
        off += LT.padded(n)
    assert total == off
    assert launches == len(groups) == LT.cdiv(n_leaves, LT.MAX_LEAVES)
    _, _, _, none = FU._sweep_plan(((0,), (0, 3)), dtype, FU.UPDATE_TILE,
                                   inputs=3, fp32_output=True)
    assert none == 0


def test_update_wrappers_refuse_cpu_mixed_device_and_dtype():
    """The kernels' own wrappers never compute on the CPU and refuse
    operands they do not take before any launch: CPU tensors, dtypes other
    than fp32 and bf16, a momentum not in fp32, leaves of mixed dtypes,
    operand lists of unequal length.  The tree forms refuse leaves on mixed
    devices."""
    x, x16 = torch.randn(4, 10), torch.randn(4, 10).bfloat16()
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        FU.local_update_leaves([x], [x], [x], ETA)
    with pytest.raises(ValueError, match="CUDA"):
        FU.server_update_leaves([x], [x], [x], GAMMA, ALPHA_ETA)
    with pytest.raises(ValueError, match="CUDA"):
        FU.server_update(x, x, x, GAMMA, ALPHA_ETA)
    with pytest.raises(ValueError, match="not supported"):
        FU.local_update_leaves([x.double()] * 2, [x.double()] * 2,
                               [x.double()] * 2, ETA)
    with pytest.raises(ValueError, match="not supported"):
        FU.server_update_leaves([x], [x], [x.half()], GAMMA, ALPHA_ETA)
    with pytest.raises(ValueError):
        FU.server_update_leaves([x16], [x16], [x16], GAMMA, ALPHA_ETA)
    with pytest.raises(ValueError):
        FU.local_update_leaves([x, x16], [x, x16], [x, x16], ETA)
    with pytest.raises(ValueError, match="leaves"):
        FU.local_update_leaves([x, x], [x], [x, x], ETA)
    with pytest.raises(ValueError, match="leaves"):
        FU.server_update_leaves([x], [x], [], GAMMA, ALPHA_ETA)
    assert FU.local_update_leaves([], [], [], ETA) == []
    assert FU.server_update_leaves([], [], [], GAMMA, ALPHA_ETA) == ([], [])
    assert ops.launch_counts()["local_update"] == 0
    assert ops.launch_counts()["server_update"] == 0
    meta = {"a": x, "b": torch.randn(4, 10, device="meta")}
    with pytest.raises(ValueError, match="mixed devices"):
        ops.fedadc_local_update_tree(meta, meta, meta, ETA)
    with pytest.raises(ValueError, match="mixed devices"):
        ops.fedadc_server_update_tree(meta, meta, meta, GAMMA, ALPHA_ETA)
