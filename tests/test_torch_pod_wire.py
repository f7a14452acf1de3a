"""The port's pod engine on the wire, with the EF client store, the fleet,
telemetry and the drivers, held against the reference on the CPU.

The engine's rounds run at ``lm_round``'s model (``test_torch_pod``'s
harness: the reference's init converted, numpy tokens, two rounds of CP 1
x CS 2 x H 2 at L 32, the same bars).  The bit-for-bit contracts
(identity wire and codec bypass, the lossless delta downlink and the
plain one, sparse-native and dense decode, one fleet region and flat,
telemetry off and none) are held between two runs of the port.  QSGD's
draws are the reference's own (``PodDraws``).

Each wire round of the port starts from the reference's state before
it (``wire_rounds``), so a top-k selection or a stochastic rounding that
flips at its boundary is counted in one round and not compounded; the
tests say how many flips they allow.
"""
import importlib
import os
import sys
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _fixtures import one_torch_thread  # noqa: F401  (autouse)
from test_torch_lm import jcfg, np_tree
from test_torch_pod import (FP32, MIXED, assert_update, fed_config,
                            make_batches, port, reference, torch_batch)

from repro.configs.base import FedConfig as JFed
from repro.configs.base import RunConfig as JRun
from repro.data.synthetic import make_token_dataset as j_tokens
from repro.federated import aggregation as JA
from repro.federated import store as JS
from repro.federated.fleet import hierarchy as JH
from repro.federated.fleet.scheduler import Cohort as JCohort
from repro.federated.fleet.scheduler import FleetScheduler as JSched
from repro.launch import train as JT
from repro.telemetry import Telemetry as JTelemetry
from repro_torch import convert
from repro_torch import pod_finetune
from repro_torch.benchmarks import lm_round
from repro_torch.checkpointing import restore_checkpoint
from repro_torch.core import tree as T
from repro_torch.core.strategies import get_strategy
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.federated import aggregation as A
from repro_torch.federated import store as CS
from repro_torch.federated.compression import SparseLeaf
from repro_torch.federated.fleet import hierarchy as FH
from repro_torch.federated.fleet.scheduler import Cohort, FleetScheduler
from repro_torch.launch import train as PT
from repro_torch.telemetry import Telemetry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def lm():
    return lm_round.model_config()


def same_tree(a, b):
    la, lb = T.leaves(a), T.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def port_pair(fed_a, fed_b, rounds=2, run=FP32, CP=1, CS=2, flat_b=False):
    """Two port runs from the same reference init and batches -> their
    states after each round.  ``flat_b``: the second run takes the CP pods'
    clients as one pod's."""
    cfg = lm()
    batches = make_batches(cfg, rounds, CP=CP, CS=CS)
    jstate0 = reference(cfg, fed_a, run, [])[0][0]
    a, _ = port(cfg, fed_a, run, jstate0, batches)
    if flat_b:
        batches = [{k: v.reshape((1, CP * CS) + v.shape[2:])
                    for k, v in b.items()} for b in batches]
    b, _ = port(cfg, fed_b, run, jstate0, batches)
    return a, b


class PodDraws:
    """The reference pod engine's own uniforms, served by name.  Round t
    keys with fold_in(PRNGKey(seed), t); the uplink splits that key over
    the CP pods, a pod's over its CS clients, and a client's over the
    leaves in flatten order; the lossy downlink folds in 0xD0, then 0 for
    θ."""

    def __init__(self, seed, params, CP, CS):
        self.base = jax.random.PRNGKey(seed)
        paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(
            params)[0]]
        self.order = {"/".join(k.key for k in p): i
                      for i, p in enumerate(paths)}
        self.CP, self.CS = CP, CS

    def __call__(self, name, shape, dtype, device):
        rnd, pod, client, direction = name[:4]
        rk = jax.random.fold_in(self.base, rnd)
        if direction == "uplink":
            k = jax.random.split(jax.random.split(rk, self.CP)[pod],
                                 self.CS)[client]
        else:
            k = jax.random.fold_in(jax.random.fold_in(rk, 0xD0), name[4])
        lk = jax.random.split(k, len(self.order))[self.order[name[-1]]]
        u = jax.random.uniform(lk, tuple(shape[1:]), dtype=jnp.float32)
        return torch.from_numpy(np.array(u)).reshape(shape).to(dtype)


def port_state(jstate, cfg, fed, run):
    """The port's train state holding the reference's (numpy) state."""
    state = PT.init_state(0, cfg, fed, run, device="cpu",
                          params=convert.from_numpy(jstate["params"], "cpu"))
    state["server"] = convert.from_numpy(jstate["server"], "cpu")
    state["round"] = int(jstate["round"])
    if "clients" in jstate:
        state["clients"] = convert.from_numpy(jstate["clients"], "cpu")
    if "refs" in jstate:
        state["refs"] = {"downlink": tuple(
            convert.from_numpy(t, "cpu") for t in jstate["refs"]["downlink"])}
    return state


def wire_rounds(fed, rounds=2, CP=1, CS=2, client_ids=None, uniforms=False,
                telemetry=False, run=FP32):
    """The reference's rounds, and each round of the port started from the
    reference's state before it (a top-k selection or a stochastic
    rounding at its boundary may flip on a 1e-7 difference and move one
    entry by a whole step, so errors are held per round, not compounded)
    -> (port state after each round, reference states (the first the
    init), port auxes, reference auxes)."""
    cfg = lm()
    batches = make_batches(cfg, rounds, CP=CP, CS=CS)
    if client_ids is not None:
        for b, ids in zip(batches, client_ids):
            b["client_ids"] = np.asarray(ids, np.int32)
    jstates, jaux = reference(cfg, fed, run, batches,
                              telemetry=JTelemetry(engine="pod")
                              if telemetry else None)
    draws = PodDraws(0, jstates[0]["params"], CP, CS) if uniforms else None
    step = PT.make_train_step(cfg, fed, run, uniforms=draws,
                              telemetry=Telemetry(engine="pod") if telemetry
                              else None)
    pstates, paux = [], []
    for js, b in zip(jstates, batches):
        state, aux = step(port_state(js, cfg, fed, run), torch_batch(b))
        pstates.append(state)
        paux.append(aux)
    return pstates, jstates, paux, jaux


def assert_params_and_m(pstates, jstates, fed, tol=1e-5, flips=0):
    """Each round's parameters and momentum (see ``assert_update``), that
    round started from the reference's state."""
    for r, ps in enumerate(pstates):
        p0 = jstates[r]["params"]
        assert_update(ps["params"], jstates[r + 1]["params"], p0, 1,
                      fed.local_steps, tol, base=p0, flips=flips)
        if "m" in jstates[r + 1]["server"]:
            assert_update(ps["server"]["m"], jstates[r + 1]["server"]["m"],
                          p0, 1, fed.local_steps, tol, over=fed.eta,
                          flips=flips)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------
def test_identity_wire_is_bit_for_bit_the_bypass():
    a, b = port_pair(fed_config(), fed_config(compressor="identity",
                                              downlink_compressor="identity"))
    assert same_tree(a[-1]["params"], b[-1]["params"])
    assert same_tree(a[-1]["server"], b[-1]["server"])


def test_lossless_delta_downlink_is_bit_for_bit_plain():
    a, b = port_pair(fed_config(), fed_config(downlink_compressor="delta"))
    assert same_tree(a[-1]["params"], b[-1]["params"])
    assert "refs" not in a[-1] and "refs" not in b[-1]


def test_topk_ef_store_matches_reference():
    """Top-k 10% with EF over a fleet of 5, rounds on clients (1, 4) and
    (4, 2): params, m and the whole store after each round; the rows no
    round touched stay zero in both.  At these leaves (up to 360,448
    entries, k a tenth) the magnitudes next to the k-th lie ~1e-8 apart,
    closer than the packages' ~1e-9 difference in Δ at times: measured one
    entry of a leaf selected by one package and not the other in 3 of 23
    leaves in round 2, so 4 may flip, each moving θ by at most one entry of
    one client.  A residual is the unsent part of one client's delta: it
    is held within 1e-5 of the round's max |Δθ| beyond the same ulps of θ,
    and a flipped entry within its leaf's largest residual."""
    fed = fed_config(compressor="topk", topk_frac=0.1, n_clients=5)
    pstates, jstates, _, _ = wire_rounds(fed, client_ids=[[[1, 4]],
                                                          [[4, 2]]])
    assert_params_and_m(pstates, jstates, fed, flips=4)
    for r, ps in enumerate(pstates):
        got = jax.tree.leaves(convert.to_numpy(ps["clients"]["ef"]))
        want = jax.tree.leaves(jstates[r + 1]["clients"]["ef"])
        p0 = jax.tree.leaves(jstates[r]["params"])
        scale = max(float(np.abs(a - b).max()) for a, b in zip(
            p0, jax.tree.leaves(jstates[r + 1]["params"])))
        for g, w, p in zip(got, want, p0):
            assert not g[[0, 3]].any() and not w[[0, 3]].any()
            slack = (fed.local_steps + 1) * np.spacing(
                np.abs(p).astype(np.float32))
            excess = np.sort(np.maximum(np.abs(g - w) - slack, 0),
                             axis=None)
            assert excess[-5] <= 1e-5 * scale
            assert excess[-1] <= 1.0001 * np.abs(w).max()


def test_sparse_native_is_bit_for_bit_dense_decode():
    """The reference's own contract: the sparse (value, index) wire added
    into the accumulator at k cost equals its dense decode bit for bit,
    parameters and residuals."""
    kw = dict(compressor="topk", topk_frac=0.1, sparse_uplink=True,
              n_clients=4)
    a, b = port_pair(fed_config(sparse_aggregate=False, **kw),
                     fed_config(sparse_aggregate=True, **kw))
    assert same_tree(a[-1]["params"], b[-1]["params"])
    assert same_tree(a[-1]["clients"], b[-1]["clients"])


def test_qsgd_with_delta_qsgd_downlink_matches_reference():
    """QSGD 4 bits up, delta+QSGD 8 bits down, on the reference's draws;
    the downlink reference rides in state["refs"].  A stochastic rounding
    flips where |v|·s/scale + u lands within the packages' 1e-6 of an
    integer: measured at most 2 entries of a leaf (of 131,072 to 360,448)
    a round, so 4 may flip, each moving θ by at most one level of one
    client."""
    fed = fed_config(compressor="qsgd", qsgd_bits=4, n_clients=4,
                     downlink_compressor="delta+qsgd", downlink_qsgd_bits=8)
    pstates, jstates, _, _ = wire_rounds(fed, uniforms=True)
    assert_params_and_m(pstates, jstates, fed, flips=4)
    for r, ps in enumerate(pstates):
        # the θ the clients hold (the ctx is derived from its delta)
        assert_update(ps["refs"]["downlink"][0],
                      jstates[r + 1]["refs"]["downlink"][0],
                      jstates[r]["params"], 1, fed.local_steps,
                      base=jstates[r]["refs"]["downlink"][0], flips=4)


def test_default_draws_are_seeded_from_the_run_seed():
    """Without ``uniforms=`` QSGD draws from a generator seeded from
    (run.seed, round): the same seed gives the same bits, another seed
    other ones."""
    cfg = lm()
    fed = fed_config(compressor="qsgd", qsgd_bits=4, n_clients=4)
    batches = make_batches(cfg, 1)
    jstate0 = reference(cfg, fed, FP32, [])[0][0]
    runs = [port(cfg, fed, replace(FP32, seed=seed), jstate0, batches)[0][-1]
            for seed in (0, 0, 1)]
    assert same_tree(runs[0]["params"], runs[1]["params"])
    assert not same_tree(runs[0]["params"], runs[2]["params"])


def test_wire_bytes_match_the_reference_counters():
    """The uplink and downlink counters of the sparse top-k wire in the
    mixed round, and the unicast ledger over three rounds, equal the
    reference's; the uplink counts the bf16 wire."""
    cfg = lm()
    for fed in (fed_config(compressor="topk", topk_frac=0.1,
                           sparse_uplink=True),
                fed_config(downlink_compressor="delta", n_clients=6,
                           downlink_unicast=True, resync_horizon=1)):
        ps = PT.make_train_step(cfg, fed, MIXED)
        js = JT.make_train_step(jcfg(cfg), JFed(**asdict(fed)),
                                JRun(**asdict(MIXED)))
        if fed.downlink_unicast:
            for ids in ([0, 1], [1, 2], [0, 5]):
                ps.account_round(client_ids=np.array(ids))
                js.account_round(client_ids=np.array(ids))
            assert (ps.refs.catchups, ps.refs.resyncs) == \
                (js.refs.catchups, js.refs.resyncs)
        else:
            ps.account_round(4)
            js.account_round(4)
            wire = T.tree_map(lambda p: torch.empty(p.shape,
                                                    dtype=torch.bfloat16,
                                                    device="meta"),
                              PT.state_shapes(cfg, fed, MIXED)["params"])
            assert ps.transport.uplink_bytes == \
                4 * ps.transport.uplink_wire_nbytes(wire)
        for name in ("uplink_bytes", "uplink_bytes_raw", "downlink_bytes",
                     "downlink_bytes_raw"):
            assert getattr(ps.transport, name) == \
                getattr(js.transport, name), name


# ---------------------------------------------------------------------------
# pods, the fleet, DRAG, telemetry
# ---------------------------------------------------------------------------
def test_two_pods_match_reference_and_one_pod():
    """CP 2 x CS 1 against the reference's vmapped pods, and against CP 1
    x CS 2 over the same clients (equal by linearity, to rounding)."""
    fed = fed_config()
    pstates, jstates, _, _ = wire_rounds(fed, CP=2, CS=1)
    assert_params_and_m(pstates, jstates, fed)
    a, b = port_pair(fed, fed, CP=2, CS=1, flat_b=True)
    assert_update(b[-1]["params"], convert.to_numpy(a[-1]["params"]),
                  jstates[0]["params"], 2, 2, base=jstates[0]["params"])


def test_one_fleet_region_is_bit_for_bit_flat():
    a, b = port_pair(fed_config(), fed_config(fleet_regions=1), CP=2, CS=1)
    assert same_tree(a[-1]["params"], b[-1]["params"])
    assert same_tree(a[-1]["server"], b[-1]["server"])


def test_two_fleet_regions_match_reference():
    fed = fed_config(fleet_regions=2)
    pstates, jstates, _, _ = wire_rounds(fed, CP=2, CS=1)
    assert_params_and_m(pstates, jstates, fed)


def test_streaming_drag_weights_match_reference():
    """DRAG against the server momentum, streamed client by client: the
    second round's weights are exp(−4·(1 − cos)) of the momentum's
    cosines.  The reference sums those dots in fp32 through XLA's CPU dot,
    up to 2.3e-5 low at 131k elements (``test_torch_comm_sweep``'s
    finding), and λ = 4 multiplies that error into the weights: held
    within 1e-4 of max |Δθ| (measured 2.2e-5)."""
    fed = fed_config(aggregator="drag")
    pstates, jstates, _, _ = wire_rounds(fed)
    assert_params_and_m(pstates, jstates, fed, tol=1e-4)


def test_streaming_weight_matches_reference():
    rng = np.random.RandomState(5)
    d = {"a": rng.randn(6, 4).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    m = {k: rng.randn(*v.shape).astype(np.float32) for k, v in d.items()}
    td = convert.from_numpy(d, "cpu")
    tm = convert.from_numpy(m, "cpu")
    jd = jax.tree.map(jnp.asarray, d)
    jm = jax.tree.map(jnp.asarray, m)
    for name in ("uniform", "examples", "drag"):
        got = A.streaming_weight(td, tm, name, 4.0)
        want = JA.streaming_weight(jd, jm, name, 4.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    idx = np.array([1, 7, 3], np.int32)
    sw = {"a": SparseLeaf(torch.from_numpy(d["a"].reshape(-1)[idx]),
                          torch.from_numpy(idx)),
          "b": SparseLeaf(torch.from_numpy(d["b"][:2]),
                          torch.tensor([0, 4], dtype=torch.int32))}
    from repro.federated.compression import SparseLeaf as JSparse
    jsw = {"a": JSparse(jnp.asarray(d["a"].reshape(-1)[idx]),
                        jnp.asarray(idx)),
           "b": JSparse(jnp.asarray(d["b"][:2]), jnp.asarray([0, 4]))}
    np.testing.assert_allclose(
        float(A.streaming_weight(sw, tm, "drag", 4.0)),
        float(JA.streaming_weight(jsw, jm, "drag", 4.0)), rtol=1e-6)
    with pytest.raises(ValueError, match="momentum"):
        A.streaming_weight(td, None, "drag", 4.0)
    with pytest.raises(ValueError, match="unknown aggregator"):
        A.streaming_weight(td, tm, "median", 4.0)


def f64_norm(tree):
    return np.sqrt(sum(float(np.sum(np.asarray(x, np.float64) ** 2))
                       for x in jax.tree.leaves(tree)))


def test_telemetry_scalars_match_reference():
    """Top-k + EF, so all four scalars.  ||Δ̄||, cos(m, Δ̄) and the mean EF
    norm within 1e-4 of their float64 values from the reference's own
    states (Δ̄ = η·(m' − γ·m), the EF rows of the round's clients).  The
    reference's own scalars sum fp32 squares through XLA's CPU dot, which
    falls up to 2.7e-3 low on this model's ||Δ̄|| (measured; ROADMAP Queue
    3), and its dispersion divides by that norm squared: the dispersions
    agree within 1e-2 relative (measured 1.0e-3)."""
    fed = fed_config(compressor="topk", topk_frac=0.1, n_clients=4)
    pstates, jstates, paux, jaux = wire_rounds(fed, telemetry=True)
    assert_params_and_m(pstates, jstates, fed, flips=4)
    gamma = fed.beta_global - fed.beta_local
    for r, (a, b) in enumerate(zip(paux, jaux)):
        assert set(a["telemetry"]) == set(b["telemetry"]) == {
            "delta_dispersion", "update_norm", "momentum_alignment",
            "ef_residual_norm"}
        for v in a["telemetry"].values():
            assert isinstance(v, torch.Tensor) and v.dim() == 0
        got = {k: float(v) for k, v in a["telemetry"].items()}
        m0, m1 = jstates[r]["server"]["m"], jstates[r + 1]["server"]["m"]
        mean = jax.tree.map(lambda x, y: fed.eta * (
            np.asarray(y, np.float64) - gamma * np.asarray(x, np.float64)),
            m0, m1)
        norm, mnorm = f64_norm(mean), f64_norm(m0)
        dot = sum(float(np.sum(np.asarray(x, np.float64) * y))
                  for x, y in zip(jax.tree.leaves(m0),
                                  jax.tree.leaves(mean)))
        cos = dot / (norm * mnorm) if mnorm > 0 else 0.0
        efs = jstates[r + 1]["clients"]["ef"]
        ef = np.mean([f64_norm(jax.tree.map(lambda x: x[c], efs))
                      for c in range(2)])
        for k, want in (("update_norm", norm), ("momentum_alignment", cos),
                        ("ef_residual_norm", ef)):
            assert abs(got[k] - want) <= 1e-4 * max(abs(want), 1e-3), k
        want = float(b["telemetry"]["delta_dispersion"])
        assert abs(got["delta_dispersion"] - want) <= 1e-2 * abs(want)


def test_telemetry_off_is_bit_for_bit_none():
    cfg = lm()
    fed = fed_config(compressor="topk", topk_frac=0.1, n_clients=4)
    batches = make_batches(cfg, 2)
    jstate0 = reference(cfg, fed, FP32, [])[0][0]
    a, aa = port(cfg, fed, FP32, jstate0, batches)
    b, ab = port(cfg, fed, FP32, jstate0, batches,
                 telemetry=Telemetry.disabled("pod"))
    assert same_tree(a[-1]["params"], b[-1]["params"])
    assert same_tree(a[-1]["clients"], b[-1]["clients"])
    assert set(aa[-1]) == set(ab[-1]) == {"loss"}


# ---------------------------------------------------------------------------
# the store, the scheduler, the data
# ---------------------------------------------------------------------------
def test_sharded_store_matches_reference_with_duplicate_ids():
    rng = np.random.RandomState(2)
    tmpl = {"w": np.zeros((3, 2), np.float32), "b": np.zeros((4,),
                                                              np.float32)}
    store = CS.sharded_init(convert.from_numpy(tmpl, "cpu"), 5)
    jstore = JS.sharded_init(jax.tree.map(jnp.asarray, tmpl), 5)
    assert all(t.shape[0] == 5 and not t.any() for t in T.leaves(store))
    for ids in ([1, 3, 1], [4, 4, 0, 4], [2]):
        vals = {k: rng.randn(len(ids), *v.shape).astype(np.float32)
                for k, v in tmpl.items()}
        ti = torch.tensor(ids)
        store = CS.sharded_scatter(store, ti, convert.from_numpy(vals, "cpu"))
        jstore = JS.sharded_scatter(jstore, jnp.asarray(ids),
                                    jax.tree.map(jnp.asarray, vals))
        for g, w in zip(jax.tree.leaves(convert.to_numpy(store)),
                        jax.tree.leaves(np_tree(jstore))):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(jax.tree.leaves(convert.to_numpy(
                CS.sharded_gather(store, ti))), jax.tree.leaves(
                np_tree(JS.sharded_gather(jstore, jnp.asarray(ids))))):
            np.testing.assert_array_equal(g, w)


def test_train_step_writes_the_ef_store_in_place():
    """The store is written in place, not copied (8 bf16 copies of
    zamba2-1.2b are 17.7 GB): the new state's store is the given state's
    tree, holding the round's residuals in the rows of its clients (1, 3)
    and zeros elsewhere; the parameters and the momentum are new
    tensors."""
    cfg = lm()
    fed = fed_config(compressor="topk", topk_frac=0.1, n_clients=4)
    state = PT.init_state(0, cfg, fed, FP32, device="cpu")
    store = state["clients"]["ef"]
    batch = torch_batch(make_batches(cfg, 1)[0])
    batch["client_ids"] = torch.tensor([[1, 3]])
    new, _ = PT.make_train_step(cfg, fed, FP32)(state, batch)
    assert all(a is b for a, b in zip(T.leaves(new["clients"]["ef"]),
                                      T.leaves(store)))
    assert all(x[[1, 3]].any() and not x[[0, 2]].any()
               for x in T.leaves(store) if x.shape[1:].numel() > 1)
    old = T.leaves(state["params"]) + T.leaves(state["server"])
    assert not any(a is b for a, b in zip(
        T.leaves(new["params"]) + T.leaves(new["server"]), old))
    ids = torch.tensor([0, 0])
    assert all(a is b for a, b in zip(T.leaves(CS.sharded_scatter(
        store, ids, CS.sharded_gather(store, ids))), T.leaves(store)))


def test_pod_client_ids_match_reference():
    fed = fed_config(n_clients=12, fleet_regions=3)
    got = FleetScheduler(fed, seed=4).sample_cohort(6)
    want = JSched(JFed(**asdict(fed)), seed=4).sample_cohort(6)
    np.testing.assert_array_equal(got.pod_client_ids(2, 3),
                                  want.pod_client_ids(2, 3))
    assert got.pod_client_ids(2, 3).dtype == np.int32
    for cohort in (got, JCohort(want.clients, want.sizes)):
        with pytest.raises(ValueError, match="pod grid"):
            cohort.pod_client_ids(4, 2)
    assert isinstance(got, Cohort)


def test_hierarchical_combine_matches_reference():
    rng = np.random.RandomState(1)
    parts = {"w": rng.randn(4, 3, 2).astype(np.float32)}
    w = rng.rand(4).astype(np.float32) + 0.5
    for r in (1, 2, 4):
        fed = fed_config(fleet_regions=r)
        got = FH.hierarchical_combine(convert.from_numpy(parts, "cpu"),
                                      torch.from_numpy(w), fed,
                                      get_strategy("fedadc"))
        from repro.core.strategies import get_strategy as jget
        want = JH.hierarchical_combine(jax.tree.map(jnp.asarray, parts),
                                       jnp.asarray(w), JFed(**asdict(fed)),
                                       jget("fedadc"))
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                                   rtol=1e-6, atol=1e-7)


def test_make_token_dataset_is_the_reference():
    for args in ((40, 17, 1024, 0), (9, 5, 64, 3, 4)):
        got, want = make_token_dataset(*args), j_tokens(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------
class Recorder:
    """A stand-in for make_train_step that keeps every batch and leaves the
    state as it is."""

    def __init__(self, port):
        self.port, self.batches = port, []

    def __call__(self, mcfg, fed, run, *a, **k):
        def step(state, batch):
            self.batches.append({n: np.asarray(v.cpu() if self.port else v)
                                 for n, v in batch.items()})
            loss = torch.zeros(()) if self.port else jnp.zeros(())
            return state, {"loss": loss}
        self.fed, self.run = fed, run
        return step


def test_lm_round_driver_makes_the_reference_calls(monkeypatch):
    """Training stubbed, ROUNDS cut to 3: the same configs, the same
    batches, the same row names and formats."""
    rmod = importlib.import_module("benchmarks.lm_round")
    got_rows, want_rows = [], []
    for mod, rows, is_port in ((lm_round, got_rows, True),
                               (rmod, want_rows, False)):
        rec = Recorder(is_port)
        monkeypatch.setattr(mod, "ROUNDS", 3)
        monkeypatch.setattr(mod, "make_train_step", rec)
        if is_port:
            mod.main(rows, device="cpu")
            got = rec
        else:
            # the recorder keeps host copies: run the driver's jitted
            # functions eagerly
            monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
            mod.main(rows)
            want = rec
    assert asdict(got.fed) == asdict(want.fed)
    assert asdict(got.run) == asdict(want.run)
    assert len(got.batches) == len(want.batches) == 6
    for g, w in zip(got.batches, want.batches):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert [r.split(",")[0] for r in got_rows] == \
        [r.split(",")[0] for r in want_rows]
    assert got_rows[-1].split(",")[2].endswith("(negative = FedADC better)")
    assert asdict(lm_round.model_config()) == asdict(
        replace(lm_round.model_config()))


def test_run_only_lm_round_runs_it(monkeypatch, capsys):
    run = importlib.import_module("repro_torch.benchmarks.run")
    monkeypatch.setattr(lm_round, "run", lambda strat, eta, device=None:
                        (1.5 if strat == "fedadc" else 2.0, 10.0))
    assert "lm_round" not in run.UNPORTED
    assert run.main(["--only", "lm_round", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "lm_round.fedadc_minus_fedavg,0,-0.5000" in out
    assert run.main(["--only", "roofline_report", "--device", "cpu"]) == 2


def test_pod_finetune_makes_the_reference_calls(monkeypatch, capsys):
    """Training stubbed, 3 rounds: the same configs and batches, and the
    same header line."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    rmod = importlib.import_module("pod_finetune")
    recs = []
    for mod, is_port in ((pod_finetune, True), (rmod, False)):
        rec = Recorder(is_port)
        recs.append(rec)
        monkeypatch.setattr(mod, "make_train_step", rec)
        monkeypatch.setattr(mod, "save_checkpoint", lambda *a: "ckpt")
        if is_port:
            mod.main(["--rounds", "3", "--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["pod_finetune.py", "--rounds",
                                              "3"])
            monkeypatch.setattr(jax, "jit", lambda f, *a, **k: f)
            mod.main()
    got, want = recs
    assert asdict(got.fed) == asdict(want.fed)
    assert asdict(got.run) == asdict(want.run)
    for g, w in zip(got.batches, want.batches):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[2] and lines[0].startswith("qwen3-4b-reduced: ")


def test_pod_finetune_checkpoint_restores_bit_for_bit(tmp_path, capsys):
    state = pod_finetune.main(["--rounds", "1", "--device", "cpu",
                               "--ckpt-dir", str(tmp_path)])
    assert "saved" in capsys.readouterr().out
    back = restore_checkpoint(str(tmp_path), 1, state["params"])
    assert same_tree(back, state["params"])


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pod_finetune.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_round.run("fedadc", 0.05)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.init_state(0, lm(), fed_config(), FP32)
