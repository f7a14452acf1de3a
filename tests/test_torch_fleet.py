"""The port's fleet substrate against the JAX package's, mirroring
``test_fleet.py`` and ``test_transport.py``'s hierarchical engine parity:
the region split, the two-tier aggregate (bit for bit the flat one at
R = 1, within 1e-5 of the reference's at R = 2 and 3), the paged client
store (eviction, budget, spill_dir, gauges, namespaces, bit-for-bit round
trips in fp32, bf16 and fp8, the unicast reference pages), the
``FleetScheduler``'s picks (equal to the reference's under the same seed)
and the engines over all three."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import HeteroConfig as JHeteroConfig
from repro.core.strategies import get_strategy as jget_strategy
from repro.data.partition import sort_and_partition
from repro.data.synthetic import make_image_dataset
from repro.federated import aggregation as JA
from repro.federated.fleet import Cohort as JCohort
from repro.federated.fleet import FleetScheduler as JFleetScheduler
from repro.federated.fleet import hierarchical_aggregate as jhier
from repro.federated.fleet import region_sizes as jregion_sizes
from repro.federated.fleet import region_slices as jregion_slices
from repro.federated.simulator import FederatedSimulator as JSim
from repro.federated.simulator import SimConfig as JSimConfig
from repro.federated.transport import SparseLeaf as JSparseLeaf
from repro_torch import convert
from repro_torch.checkpointing.checkpoint import storage_view
from repro_torch.configs.base import FedConfig, HeteroConfig
from repro_torch.core import tree as T
from repro_torch.core.strategies import get_strategy
from repro_torch.federated import aggregation as A
from repro_torch.federated.async_engine import AsyncFederatedSimulator
from repro_torch.federated.compression import SparseLeaf
from repro_torch.federated.fleet import (Cohort, FleetScheduler,
                                         HierarchicalAggregator,
                                         PagedClientStore,
                                         hierarchical_aggregate, page_nbytes,
                                         region_sizes, region_slices)
from repro_torch.federated.fleet.hierarchy import slices_of
from repro_torch.federated.reference import ReferenceStore
from repro_torch.federated.simulator import FederatedSimulator, SimConfig
from repro_torch.federated.store import ClientStore
from repro_torch.federated.transport import Transport
from repro_torch.telemetry import Counters

FP_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}


def bits_equal(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert storage_view(x).tobytes() == storage_view(y).tobytes()


# ---------------------------------------------------------------------------
# the region split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("total,r", [(10, 3), (6, 3), (5, 5), (7, 2),
                                     (100, 9), (16, 16), (11, 4)])
def test_region_split_matches_reference(total, r):
    assert region_sizes(total, r) == jregion_sizes(total, r)
    assert region_slices(total, r) == jregion_slices(total, r)


@pytest.mark.parametrize("total,r,match", [(4, 0, ">= 1"),
                                           (2, 3, "cannot fill")])
def test_region_split_rejects_bad_splits(total, r, match):
    with pytest.raises(ValueError, match=match):
        region_sizes(total, r)
    with pytest.raises(ValueError, match=match):
        jregion_sizes(total, r)


# ---------------------------------------------------------------------------
# the two-tier aggregate
# ---------------------------------------------------------------------------
def stacked_numpy(k, seed=0, shapes=((33, 9), (17,))):
    rng = np.random.RandomState(seed)
    return {f"l{i}": rng.randn(k, *s).astype(np.float32)
            for i, s in enumerate(shapes)}


def to_torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def sparse_wire(k, seed=0, n=(297, 17), kk=(30, 4)):
    """Stacked top-k-like wires (unique indices per client) for both
    packages from the same numpy draws."""
    rng = np.random.RandomState(seed)
    port, ref = {}, {}
    for i, (ni, ki) in enumerate(zip(n, kk)):
        vals = rng.randn(k, ki).astype(np.float32)
        idx = np.stack([rng.permutation(ni)[:ki] for _ in range(k)]
                       ).astype(np.int32)
        port[f"l{i}"] = SparseLeaf(torch.from_numpy(vals),
                                   torch.from_numpy(idx))
        ref[f"l{i}"] = JSparseLeaf(jnp.asarray(vals), jnp.asarray(idx))
    like = {"l0": torch.zeros(33, 9), "l1": torch.zeros(17)}
    return port, ref, like


def test_one_region_bitwise_flat_dense():
    fed = FedConfig(fleet_regions=1, clients_per_round=6)
    strat = get_strategy("fedadc")
    deltas = to_torch(stacked_numpy(6))
    w = torch.tensor([0.5, 1.2, 0.1, 2.0, 0.7, 0.9])
    bits_equal(hierarchical_aggregate(deltas, w, fed, strat),
               strat.server_aggregate(deltas, w, fed))


def test_one_region_bitwise_flat_sparse():
    wire, _, like = sparse_wire(3, seed=1)
    w = torch.tensor([0.3, 0.5, 0.2])
    fed = FedConfig(fleet_regions=1, clients_per_round=3)
    bits_equal(hierarchical_aggregate(wire, w, fed, get_strategy("fedadc"),
                                      like=like),
               A.sparse_weighted_mean(wire, w, like))


@pytest.mark.parametrize("r", [2, 3])
def test_multi_region_matches_reference_dense(r):
    deltas = stacked_numpy(7, seed=r)
    w = np.random.RandomState(0).uniform(0.1, 2.0, 7).astype(np.float32)
    got = hierarchical_aggregate(to_torch(deltas), torch.from_numpy(w),
                                 FedConfig(fleet_regions=r,
                                           clients_per_round=7),
                                 get_strategy("fedadc"))
    want = jhier({k: jnp.asarray(v) for k, v in deltas.items()},
                 jnp.asarray(w),
                 JFedConfig(fleet_regions=r, clients_per_round=7),
                 jget_strategy("fedadc"))
    for k in deltas:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("r", [2, 3])
def test_multi_region_matches_reference_sparse(r):
    port, ref, like = sparse_wire(6, seed=r)
    w = np.random.RandomState(1).uniform(0.1, 2.0, 6).astype(np.float32)
    got = hierarchical_aggregate(port, torch.from_numpy(w),
                                 FedConfig(fleet_regions=r,
                                           clients_per_round=6),
                                 get_strategy("fedadc"), like=like)
    want = jhier(ref, jnp.asarray(w),
                 JFedConfig(fleet_regions=r, clients_per_round=6),
                 jget_strategy("fedadc"),
                 like={k: jnp.asarray(v.numpy()) for k, v in like.items()})
    for k in like:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-5)
    flat = JA.sparse_weighted_mean(
        ref, jnp.asarray(w), {k: jnp.asarray(v.numpy())
                              for k, v in like.items()})
    for k in like:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(flat[k]),
                                   rtol=0, atol=1e-5)


def test_sparse_requires_template_and_regions_fit_the_round():
    wire, _, _ = sparse_wire(1)
    with pytest.raises(ValueError, match="like"):
        hierarchical_aggregate(wire, torch.ones(1),
                               FedConfig(fleet_regions=1,
                                         clients_per_round=1),
                               get_strategy("fedadc"))
    with pytest.raises(ValueError, match="region"):
        HierarchicalAggregator(FedConfig(fleet_regions=5,
                                         clients_per_round=3),
                               get_strategy("fedadc"))
    # buffer_k is the async round size when set
    HierarchicalAggregator(FedConfig(fleet_regions=5, clients_per_round=3,
                                     buffer_k=5), get_strategy("fedadc"))


# ---------------------------------------------------------------------------
# the paged client store
# ---------------------------------------------------------------------------
def paged(budget, **kw):
    s = PagedClientStore(budget_bytes=budget, **kw)
    s.register("ef", lambda: torch.zeros(8))
    return s


PAGE = 8 * 4


def test_gather_initialises_then_round_trips():
    s = paged(10 ** 6)
    got = s.gather("ef", [0, 1])
    assert got.shape == (2, 8) and not got.any()
    vals = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    s.scatter("ef", [0, 1], vals)
    bits_equal(s.gather("ef", [0, 1]), vals)


def test_eviction_under_one_page_budget():
    s = paged(PAGE, counters=Counters())
    vals = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    s.scatter("ef", [0, 1, 2], vals)
    assert s.resident_pages == 1 and s.spilled_pages == 2
    assert s.resident_bytes == PAGE <= s.budget_bytes
    for c in (0, 1, 2):
        bits_equal(s.gather("ef", [c]), vals[c:c + 1])
    assert s.counters.snapshot()["store.loads"] >= 2


@pytest.mark.parametrize("dtype", sorted(FP_DTYPES))
def test_spilled_page_round_trips_bitwise(dtype):
    """Evict, compress the bits, load: bit for bit in every dtype, -0.0
    and the smallest subnormal included."""
    dt = FP_DTYPES[dtype]
    s = PagedClientStore(budget_bytes=16 * torch.finfo(dt).bits // 8)
    s.register("st", lambda: torch.zeros(16, dtype=dt))
    vals = torch.from_numpy(np.random.RandomState(3).randn(3, 16)
                            .astype(np.float32)).to(dt)
    vals[:, 0] = -0.0
    vals[:, 1] = torch.finfo(dt).smallest_normal / 2
    s.scatter("st", [0, 1, 2], vals)
    assert s.spilled_pages == 2            # the budget holds one page
    bits_equal(s.gather("st", [0, 1, 2]), vals)


def test_scatter_to_evicted_page_supersedes_spill():
    s = paged(PAGE)
    s.scatter("ef", [0], torch.ones(1, 8))
    s.scatter("ef", [1], torch.ones(1, 8) * 2)    # evicts client 0
    assert s.spilled_pages == 1
    v2 = torch.full((1, 8), 7.0)
    s.scatter("ef", [0], v2)
    bits_equal(s.gather("ef", [0]), v2)
    assert s.resident_pages + s.spilled_pages == 2


def test_budget_never_exceeded():
    s = paged(3 * PAGE)
    rng = np.random.RandomState(0)
    for _ in range(5):
        ids = rng.choice(20, size=4, replace=False)
        s.scatter("ef", ids, torch.from_numpy(
            rng.randn(4, 8).astype(np.float32)))
        assert s.resident_bytes <= s.budget_bytes
    assert s.peak_resident_bytes == 3 * PAGE <= s.budget_bytes


def test_gauges_published():
    c = Counters()
    s = paged(2 * PAGE, counters=c)
    s.scatter("ef", [0, 1, 2], torch.ones(3, 8))
    snap = c.snapshot()
    assert snap["store.resident_pages"] == 2
    assert snap["store.resident_bytes"] == 2 * PAGE
    assert snap["store.spilled_pages"] == 1
    assert snap["store.spills"] == 1
    s.gather("ef", [0])
    assert c.snapshot()["store.loads"] == 1


def test_spill_dir_on_disk(tmp_path):
    s = paged(PAGE, spill_dir=str(tmp_path))
    vals = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    s.scatter("ef", [0, 1], vals)
    assert len(list(tmp_path.glob("*.page"))) == 1
    bits_equal(s.gather("ef", [0]), vals[:1])     # the load removes it
    bits_equal(s.gather("ef", [1]), vals[1:])
    assert s.spilled_pages == 1 and len(list(tmp_path.glob("*.page"))) == 1


def test_states_view_and_namespaces():
    s = paged(PAGE)
    assert s.namespaces() == ("ef",)
    s.scatter("ef", [3, 5], torch.ones(2, 8))
    view = s.states("ef")
    assert sorted(view) == [3, 5] and 3 in view and 4 not in view
    bits_equal(view[5], torch.ones(8))
    view[4] = torch.zeros(8)
    assert len(view) == 3
    del view[4]
    assert sorted(view) == [3, 5]
    assert view.get(99) is None
    with pytest.raises(KeyError):
        view[99]
    with pytest.raises(KeyError):
        s.states("nope")


def test_matches_host_backend_bitwise():
    host, store = ClientStore(), paged(2 * PAGE)
    host.register("ef", lambda: torch.zeros(8))
    rng = np.random.RandomState(1)
    for _ in range(6):
        ids = rng.choice(12, size=3, replace=False)
        gh, gp = host.gather("ef", ids), store.gather("ef", ids)
        bits_equal(gh, gp)
        upd = torch.from_numpy(rng.randn(3, 8).astype(np.float32))
        host.scatter("ef", ids, gh + upd)
        store.scatter("ef", ids, gp + upd)
    assert store.spilled_pages > 0


def test_page_nbytes_and_budget_validation():
    page = {"a": torch.zeros(4), "b": {"c": torch.zeros(2, 3,
                                                        dtype=torch.int32)}}
    assert page_nbytes(page) == 4 * 4 + 6 * 4
    with pytest.raises(ValueError, match="budget"):
        PagedClientStore(budget_bytes=0)


# ---------------------------------------------------------------------------
# the unicast reference pages under a paged store
# ---------------------------------------------------------------------------
def refs_over_paged(wire, budget_pages=1):
    fed = FedConfig(strategy="fedadc", downlink_compressor="delta",
                    downlink_unicast=True)
    t = Transport(fed, counters=Counters())
    t.set_wire_templates(wire[0], {"params": wire[0], "ctx": wire[1]})
    page = {"params": wire[0], "ctx": wire[1]}
    store = PagedClientStore(budget_bytes=budget_pages * page_nbytes(page),
                             counters=t.counters)
    return ReferenceStore(fed, t, store=store), store


@pytest.mark.parametrize("dtype", sorted(FP_DTYPES))
def test_spilled_reference_reloads_downlink_bitwise(dtype):
    dt = FP_DTYPES[dtype]
    rng = np.random.RandomState(0)
    wire = ({"w": torch.from_numpy(rng.randn(16).astype(np.float32)).to(dt)},
            {"m_bar": torch.from_numpy(rng.randn(16).astype(np.float32))
             .to(dt)})
    wire[0]["w"][0] = -0.0
    refs, store = refs_over_paged(wire)
    refs.dispatch([0, 1, 2], 0, wire=wire)
    assert store.spilled_pages == 2
    for c in (0, 1, 2):
        got = refs.client_reference(c)
        bits_equal({"p": got[0], "c": got[1]}, {"p": wire[0], "c": wire[1]})


def test_newer_reference_supersedes_evicted_page():
    rng = np.random.RandomState(1)
    w0 = ({"w": torch.from_numpy(rng.randn(16).astype(np.float32))},
          {"m_bar": torch.from_numpy(rng.randn(16).astype(np.float32))})
    w1 = (T.scale(w0[0], 2.0), T.scale(w0[1], 2.0))
    refs, store = refs_over_paged(w0)
    refs.dispatch([0, 1], 0, wire=w0)
    assert store.spilled_pages == 1
    refs.dispatch([0], 1, wire=w1)
    bits_equal(dict(zip("pc", refs.client_reference(0))), dict(zip("pc", w1)))
    bits_equal(dict(zip("pc", refs.client_reference(1))), dict(zip("pc", w0)))
    assert store.resident_pages + store.spilled_pages == 2
    assert refs.client_staleness(0, 1) == 0
    assert refs.client_staleness(1, 1) == 1


# ---------------------------------------------------------------------------
# the fleet scheduler: the reference's picks under the same seed
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k,regions,hetero,seed", [
    (40, 8, 4, None, 0),
    (40, 10, 3, None, 5),
    (10, 2, 1, dict(enabled=True, speed_dist="lognormal", seed=2), 1),
    (12, 6, 2, dict(enabled=True, availability=0.05, seed=1), 1),
    (100, 8, 4, dict(enabled=True, speed_dist="bimodal",
                     straggler_frac=0.25, availability=0.7, seed=0), 3),
])
def test_scheduler_picks_equal_reference(n, k, regions, hetero, seed):
    ours = FleetScheduler(
        FedConfig(n_clients=n, clients_per_round=k, fleet_regions=regions),
        None if hetero is None else HeteroConfig(**hetero), seed=seed)
    theirs = JFleetScheduler(
        JFedConfig(n_clients=n, clients_per_round=k, fleet_regions=regions),
        None if hetero is None else JHeteroConfig(**hetero), seed=seed)
    np.testing.assert_array_equal(ours.speeds, theirs.speeds)
    for _ in range(4):
        a, b = ours.sample_cohort(), theirs.sample_cohort()
        np.testing.assert_array_equal(a.clients, b.clients)
        assert a.sizes == b.sizes
        np.testing.assert_array_equal(ours.sample(3), theirs.sample(3))
    for r, (start, size) in enumerate(a.region_slices()):
        sub = a.clients[start:start + size]
        assert all(ours.region_of(int(c)) == r for c in sub)
        assert len(set(sub.tolist())) == size


def test_scheduler_class_coverage_equals_reference():
    n, classes = 24, 4
    counts = np.zeros((n, classes))
    counts[np.arange(n), np.arange(n) % classes] = 5
    kw = dict(n_clients=n, clients_per_round=8, fleet_regions=2)
    ours = FleetScheduler(FedConfig(**kw), selector="class_coverage",
                          counts=counts, seed=0)
    theirs = JFleetScheduler(JFedConfig(**kw), selector="class_coverage",
                             counts=counts, seed=0)
    for _ in range(3):
        np.testing.assert_array_equal(ours.sample_cohort().clients,
                                      theirs.sample_cohort().clients)


@pytest.mark.parametrize("sizes", [(3, 3), (4, 3, 3), (1,)])
def test_cohort_slices_match_reference(sizes):
    clients = np.arange(sum(sizes))
    assert Cohort(clients, sizes).region_slices() == \
        JCohort(clients, sizes).region_slices()
    assert Cohort(clients, sizes).region_slices() == \
        slices_of(sizes)


def test_cohort_grid_and_scheduler_validation():
    assert Cohort(np.arange(6), (3, 3)).region_slices() == ((0, 3), (3, 3))
    fed = FedConfig(n_clients=4, clients_per_round=2)
    with pytest.raises(ValueError, match="selector"):
        FleetScheduler(fed, selector="bogus")
    with pytest.raises(ValueError, match="counts"):
        FleetScheduler(fed, selector="class_coverage")
    with pytest.raises(ValueError, match="n_regions"):
        FleetScheduler(fed, n_regions=5)


# ---------------------------------------------------------------------------
# the engines over the fleet
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data():
    x, y, xt, yt = make_image_dataset(600, 150, 10, image_size=16, seed=0,
                                      noise=0.5)
    parts = sort_and_partition(y, 10, s=2, seed=0)
    return x, y, xt, yt, parts


def fed_kw(**kw):
    base = dict(strategy="fedadc", local_steps=2, clients_per_round=4,
                n_clients=10, eta=0.03, beta_global=0.6, beta_local=0.6)
    base.update(kw)
    return base


def sim(rounds=3):
    return SimConfig(model="cnn", n_classes=10, batch_size=16, rounds=rounds,
                     eval_every=rounds, cnn_width=8, seed=1)


SPARSE = dict(compressor="topk", topk_frac=0.1, sparse_uplink=True,
              sparse_aggregate=True)


@pytest.mark.parametrize("wire", [{}, SPARSE])
def test_sync_one_region_bit_for_bit_flat(data, wire):
    runs = []
    for regions in (0, 1):
        s = FederatedSimulator(FedConfig(**fed_kw(fleet_regions=regions,
                                                  **wire)),
                               sim(), *data, device="cpu")
        s.run()
        runs.append(s)
    bits_equal(runs[0].params, runs[1].params)
    efa, efb = runs[0].ef_states, runs[1].ef_states
    assert sorted(efa) == sorted(efb)
    for c in efa:
        bits_equal(efa[c], efb[c])


@pytest.mark.parametrize("buffer_k,hetero", [
    (0, {}), (2, dict(enabled=True, speed_dist="lognormal", seed=2))])
def test_async_one_region_bit_for_bit_flat(data, buffer_k, hetero):
    runs = []
    for regions in (0, 1):
        e = AsyncFederatedSimulator(
            FedConfig(**fed_kw(fleet_regions=regions, buffer_k=buffer_k)),
            sim(), HeteroConfig(**hetero), *data, device="cpu")
        e.run()
        runs.append(e)
    assert list(runs[0].event_log) == list(runs[1].event_log)
    bits_equal(runs[0].params, runs[1].params)


@pytest.mark.parametrize("wire", [{}, SPARSE])
def test_sync_two_regions_matches_reference(data, wire):
    """Two regions, one round, from the reference's init: the port within
    the one-round 1e-5 of each leaf's scale, the flat port within 1e-5."""
    kw = fed_kw(fleet_regions=2, **wire)
    skw = dict(model="cnn", n_classes=10, batch_size=16, rounds=1,
               eval_every=1, cnn_width=8, seed=3)
    ref = JSim(JFedConfig(**kw), JSimConfig(**skw), *data)
    params = convert.from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    port = FederatedSimulator(FedConfig(**kw), SimConfig(**skw), *data,
                              params=params, device="cpu")
    flat = FederatedSimulator(FedConfig(**dict(kw, fleet_regions=0)),
                              SimConfig(**skw), *data,
                              params=T.tree_map(torch.clone, params),
                              device="cpu")
    ref.run(), port.run(), flat.run()
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.params))
    got = jax.tree.leaves(convert.to_numpy(port.params))
    got_flat = jax.tree.leaves(convert.to_numpy(flat.params))
    for g, f, w in zip(got, got_flat, want):
        sc = np.abs(w).max()
        np.testing.assert_allclose(g / sc, w / sc, atol=1e-5, rtol=0)
        np.testing.assert_allclose(g / sc, f / sc, atol=1e-5, rtol=0)


def test_paged_store_bit_for_bit_host_store_sync(data):
    """A sync run on the top-k + EF wire over a paged store that holds two
    of the fleet's EF pages equals the plain store's run bit for bit."""
    fed = FedConfig(**fed_kw(compressor="topk", topk_frac=0.2))
    a = FederatedSimulator(fed, sim(), *data, device="cpu")
    ef_page = page_nbytes(a._ef_init())
    store = PagedClientStore(budget_bytes=2 * ef_page, counters=Counters())
    b = FederatedSimulator(fed, sim(), *data, device="cpu", store=store)
    a.run(), b.run()
    bits_equal(a.params, b.params)
    assert store.peak_resident_bytes <= store.budget_bytes
    assert store.counters.get("store.spills") > 0
    assert store.counters.get("store.loads") > 0
    assert sorted(a.ef_states) == sorted(b.ef_states)
    for c in a.ef_states:
        bits_equal(a.ef_states[c], b.ef_states[c])


def test_paged_store_bit_for_bit_host_store_async_drops(data):
    """The async engine on the sparse wire with drops over a paged store
    of one EF page: each lost upload's fold-back lands in its client's page
    (spilled or not), bit for bit the plain store's run."""
    fed = FedConfig(**fed_kw(buffer_k=2, **SPARSE))
    hetero = HeteroConfig(enabled=True, speed_dist="bimodal",
                          local_steps_choices=(1, 2), drop_prob=0.3, seed=3)
    a = AsyncFederatedSimulator(fed, sim(4), hetero, *data, device="cpu")
    store = PagedClientStore(budget_bytes=page_nbytes(a._ef_init()),
                             counters=Counters())
    b = AsyncFederatedSimulator(fed, sim(4), hetero, *data, device="cpu",
                                store=store)
    a.run(), b.run()
    assert any(kind == "drop" for kind, *_ in b.event_log)
    assert list(a.event_log) == list(b.event_log)
    bits_equal(a.params, b.params)
    assert store.counters.get("store.spills") > 0
    assert sorted(a.ef_states) == sorted(b.ef_states)
    for c in a.ef_states:
        bits_equal(a.ef_states[c], b.ef_states[c])


def test_unicast_pages_ride_paged_store_bitwise(data):
    """A unicast run over a one-page paged store thrashes every reference
    page through the spill tier, still re-serves each client's exact last
    downlink, and equals the plain store's run bit for bit."""
    fed = FedConfig(**fed_kw(downlink_compressor="delta",
                             downlink_unicast=True))
    host = FederatedSimulator(fed, sim(), *data, device="cpu")
    host.run()
    wire = host.refs._wire
    store = PagedClientStore(
        budget_bytes=page_nbytes({"params": wire[0], "ctx": wire[1]}),
        counters=Counters())
    b = FederatedSimulator(fed, sim(), *data, device="cpu", store=store)
    b.run()
    bits_equal(host.params, b.params)
    assert store.counters.get("store.spills") > 0
    for c, v in b.refs._client_version.items():
        got = dict(zip("pc", b.refs.client_reference(c)))
        want = dict(zip("pc", host.refs.client_reference(c)))
        bits_equal(got, want)
        if v == b._rounds_done - 1:
            bits_equal(got, dict(zip("pc", b.refs._wire)))


def test_scheduler_feeds_simulator_like_the_reference(data):
    """A FleetScheduler (R = 2) picks each sync round's cohort: the same
    picks as the reference's, so one round lands on the reference's
    parameters, and two runs from one seed are bit for bit equal.

    Seed 1: at seed 3 this cohort (clients 1, 4, 6, 9) meets a branch
    point, where the port against itself, its parameters perturbed by 1e-7
    relative, ends 1.3e-2 apart, as far as it ends from the reference."""
    kw = fed_kw(fleet_regions=2)
    skw = dict(model="cnn", n_classes=10, batch_size=16, rounds=1,
               eval_every=1, cnn_width=8, seed=1)
    ref = JSim(JFedConfig(**kw), JSimConfig(**skw), *data,
               scheduler=JFleetScheduler(JFedConfig(**kw), seed=5))
    params = convert.from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    runs = []
    for _ in range(2):
        s = FederatedSimulator(FedConfig(**kw), SimConfig(**skw), *data,
                               params=T.tree_map(torch.clone, params),
                               device="cpu",
                               scheduler=FleetScheduler(FedConfig(**kw),
                                                        seed=5))
        s.run()
        runs.append(s)
    ref.run()
    bits_equal(runs[0].params, runs[1].params)
    want = jax.tree.leaves(jax.tree.map(np.asarray, ref.params))
    for g, w in zip(jax.tree.leaves(convert.to_numpy(runs[0].params)), want):
        sc = np.abs(w).max()
        np.testing.assert_allclose(g / sc, w / sc, atol=1e-5, rtol=0)
    # the cohorts and the wire bytes do not read the parameters: held
    # exactly over six rounds at seed 3, past that branch point
    skw = dict(skw, rounds=6, eval_every=6, seed=3)
    ref = JSim(JFedConfig(**kw), JSimConfig(**skw), *data,
               scheduler=JFleetScheduler(JFedConfig(**kw), seed=5))
    port = FederatedSimulator(FedConfig(**kw), SimConfig(**skw), *data,
                              device="cpu",
                              scheduler=FleetScheduler(FedConfig(**kw),
                                                       seed=5))
    cohorts = [], []
    for sim, seen in zip((ref, port), cohorts):
        def spy(*a, draw=sim.scheduler.sample_cohort, seen=seen):
            cohort = draw(*a)
            seen.append(np.asarray(cohort.clients))
            return cohort
        sim.scheduler.sample_cohort = spy
    ref.run(), port.run()
    assert len(cohorts[1]) == 6
    np.testing.assert_array_equal(cohorts[0], cohorts[1])
    assert (port.uplink_bytes, port.downlink_bytes) == (ref.uplink_bytes,
                                                        ref.downlink_bytes)
    assert [h["round"] for h in port.history] == \
        [h["round"] for h in ref.history]
