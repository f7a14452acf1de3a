"""The port's semi-async engine and client system model against the JAX
package's, on ``test_hetero_async.py``'s fixture (600/150 images at 16x16,
N=10, H=4, batch 16, cnn_width=8) and its ``HETERO`` fleet (bimodal speeds,
H_i in (2, 4, 8), 5% drops, seed 3).

Both engines start from the reference's own init (converted with
``repro_torch.convert``).  The event order depends only on numpy
RandomStates, so the event log and the staleness histogram must be equal
tuple for tuple.  Bars, relative to each leaf's scale: parameters within
the one-round 1e-5 of ``test_torch_simulator.py``; the history's loss
within rtol 2e-4, its round and virtual time equal; EF residuals within
1e-4 (one client's delta, unaveraged); measured bytes and the unicast
catch-up and resync counts exact.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import HeteroConfig as JHeteroConfig
from repro.data.partition import sort_and_partition
from repro.data.synthetic import make_image_dataset
from repro.federated import hetero as jhetero
from repro.federated.async_engine import AsyncFederatedSimulator as JAsync
from repro.federated.simulator import SimConfig as JSimConfig
from repro.telemetry.tracer import Histogram as JHistogram
from repro_torch import convert
from repro_torch.configs.base import FedConfig, HeteroConfig
from repro_torch.federated import hetero
from repro_torch.federated.async_engine import (ASYNC_UNSUPPORTED,
                                                AsyncFederatedSimulator)
from repro_torch.federated.simulator import FederatedSimulator, SimConfig
from repro_torch.telemetry import Histogram

from _fixtures import (one_torch_thread,  # noqa: F401  (autouse)
                       shared_reference_jits)

HETERO = dict(enabled=True, speed_dist="bimodal", straggler_frac=0.3,
              straggler_slowdown=4.0, local_steps_choices=(2, 4, 8),
              drop_prob=0.05, seed=3)


@pytest.fixture(scope="module")
def data():
    x, y, xt, yt = make_image_dataset(600, 150, 10, image_size=16, seed=0,
                                      noise=0.5)
    parts = sort_and_partition(y, 10, s=2, seed=0)
    return x, y, xt, yt, parts


def fed_kw(**kw):
    base = dict(strategy="fedadc", local_steps=4, clients_per_round=4,
                n_clients=10, eta=0.03, beta_global=0.6, beta_local=0.6,
                buffer_k=2)
    base.update(kw)
    return base


def sim_kw(rounds=5, **kw):
    base = dict(model="cnn", n_classes=10, batch_size=16, rounds=rounds,
                eval_every=rounds, cnn_width=8, seed=1)
    base.update(kw)
    return base


def make_pair(data, fkw, skw, hkw, uniforms=None):
    x, y, xt, yt, parts = data
    ref = JAsync(JFedConfig(**fkw), JSimConfig(**skw), JHeteroConfig(**hkw),
                 x, y, xt, yt, parts)
    params = convert.from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    port = AsyncFederatedSimulator(FedConfig(**fkw), SimConfig(**skw),
                                   HeteroConfig(**hkw), x, y, xt, yt, parts,
                                   params=params, device="cpu",
                                   uniforms=uniforms)
    return ref, port


def assert_tree_close(got, want, tol, scales=None):
    got = jax.tree.leaves(convert.to_numpy(got))
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    scales = scales or [np.abs(w).max() + 1e-12 for w in want]
    for g, w, sc in zip(got, want, scales):
        np.testing.assert_allclose(g / sc, w / sc, atol=tol, rtol=0)


def assert_runs_match(ref, port, hr, hp):
    assert list(port.event_log) == list(ref.event_log)
    assert port.staleness_hist.to_dict() == ref.staleness_hist.to_dict()
    assert len(hp) == len(hr)
    for a, b in zip(hr, hp):
        assert (a["round"], a["t"]) == (b["round"], b["t"])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=2e-4)
    assert_tree_close(port.params, ref.params, 1e-5)


def assert_bookkeeping_equal(ref, port):
    """What follows from the numpy draws and the wire sizes alone, exactly:
    the event log, the staleness histogram, every byte counter, and the
    unicast ledger's catch-ups, resyncs and per-client bytes."""
    assert list(port.event_log) == list(ref.event_log)
    assert port.staleness_hist.to_dict() == ref.staleness_hist.to_dict()
    for attr in ("uplink_bytes", "uplink_bytes_raw", "downlink_bytes",
                 "downlink_bytes_raw"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert (port.refs.catchups, port.refs.resyncs) == (ref.refs.catchups,
                                                       ref.refs.resyncs)
    assert port.refs.client_bytes == ref.refs.client_bytes


def run_long_pair(data, fkw, flushes=8, seed=3):
    """Both engines for ``flushes`` flushes at ``seed``, past the near-ties
    that part their parameters (the port draws its own QSGD uniforms: the
    bookkeeping does not read them)."""
    ref, port = make_pair(data, fkw, sim_kw(rounds=flushes, seed=seed),
                          HETERO)
    hr, hp = ref.run(), port.run()
    assert [(h["round"], h["t"]) for h in hp] == \
        [(h["round"], h["t"]) for h in hr]
    assert_bookkeeping_equal(ref, port)
    return ref, port


def assert_ef_close(ref, port):
    assert sorted(port.ef_states) == sorted(ref.ef_states)
    scales = [np.abs(np.asarray(p)).max() for p in jax.tree.leaves(ref.params)]
    for c in ref.ef_states:
        assert_tree_close(port.ef_states[c], ref.ef_states[c], 1e-4, scales)


# ---------------------------------------------------------------------------
# the system model: pure numpy, every draw the reference's
# ---------------------------------------------------------------------------
def test_hetero_config_matches_reference():
    ours = [(f.name, f.default) for f in dataclasses.fields(HeteroConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(JHeteroConfig)]
    assert ours == theirs


@pytest.mark.parametrize("dist", ["constant", "lognormal", "uniform",
                                  "bimodal"])
def test_sample_speeds_bit_for_bit(dist):
    kw = dict(enabled=True, speed_dist=dist, local_steps_choices=(2, 4, 8))
    ours = hetero.sample_speeds(HeteroConfig(**kw), 100,
                                np.random.RandomState(5))
    theirs = jhetero.sample_speeds(JHeteroConfig(**kw), 100,
                                   np.random.RandomState(5))
    np.testing.assert_array_equal(ours, theirs)
    rng_a, rng_b = np.random.RandomState(6), np.random.RandomState(6)
    np.testing.assert_array_equal(
        hetero.sample_local_steps(HeteroConfig(**kw), 100, 4, rng_a),
        jhetero.sample_local_steps(JHeteroConfig(**kw), 100, 4, rng_b))
    with pytest.raises(ValueError, match="speed_dist"):
        hetero.sample_speeds(HeteroConfig(enabled=True, speed_dist="x"), 4,
                             rng_a)


def test_fednova_and_staleness_algebra():
    assert hetero.fednova_scale(2, 8) == jhetero.fednova_scale(2, 8) == 4.0
    s = np.arange(6)
    for mode, factor in (("none", 0.5), ("poly", 0.5), ("exp", 0.7)):
        np.testing.assert_array_equal(
            hetero.staleness_discount(s, mode, factor),
            jhetero.staleness_discount(s, mode, factor))
    with pytest.raises(ValueError, match="staleness_mode"):
        hetero.staleness_discount(s, "bogus")


def test_client_system_model_draws_bit_for_bit():
    kw = dict(HETERO, availability=0.7, time_jitter=0.3)
    ours = hetero.ClientSystemModel(HeteroConfig(**kw), 20, 4)
    theirs = jhetero.ClientSystemModel(JHeteroConfig(**kw), 20, 4)
    np.testing.assert_array_equal(ours.speeds, theirs.speeds)
    np.testing.assert_array_equal(ours.local_steps, theirs.local_steps)
    for c in list(range(20)) * 3:
        assert ours.round_time(c) == theirs.round_time(c)
        assert ours.is_available(c) == theirs.is_available(c)
        assert ours.drops_out(c) == theirs.drops_out(c)
        assert ours.delta_scale(c) == theirs.delta_scale(c)


def test_histogram_methods_match_reference():
    ours, theirs = Histogram(n_bins=4), JHistogram(n_bins=4)
    for h in (ours, theirs):
        h.observe_many([0, 1, 1, 3, 9])
    assert ours.to_dict() == theirs.to_dict()
    assert ours.mean() == theirs.mean() == 14 / 5
    for h in (ours, theirs):
        h.reset()
        h.observe_many([2])
    assert ours.to_dict() == theirs.to_dict() == {
        "bins": [0, 0, 1], "overflow": 0, "count": 1, "mean": 2.0, "max": 2}


# ---------------------------------------------------------------------------
# the engine against the reference's engine
# ---------------------------------------------------------------------------
def test_async_matches_reference(data):
    """The plain wire: event log, staleness, history and parameters."""
    ref, port = make_pair(data, fed_kw(), sim_kw(), HETERO)
    hr, hp = ref.run(), port.run()
    assert port.staleness_hist.max >= 1
    assert_runs_match(ref, port, hr, hp)
    assert (port.uplink_bytes, port.downlink_bytes) == (ref.uplink_bytes,
                                                        ref.downlink_bytes)


def test_async_topk_ef_unicast_matches_reference(data):
    """The example's wire (top-k 10% with EF up, the lossless delta
    downlink per client with resync_horizon 2) at seed 3: exact bytes and
    exact catch-up and resync counts, per client too.

    The parameters and EF residuals are held for two flushes: the third
    dispatches client 6, whose top-k threshold on leaf f2/w falls between
    two magnitudes 7.5e-9 apart (0.0054102540 and 0.0054102615, the latter
    τ); one fp32 rounding decides which of the two is kept, and the engines
    keep different ones (its EF residual, updated at dispatch, and after
    the fourth flush the parameters move by 3e-3 at those two entries).
    The bookkeeping does not read the values, so it is held exactly over
    eight flushes, past that tie."""
    fkw = fed_kw(compressor="topk", topk_frac=0.1,
                 downlink_compressor="delta", downlink_unicast=True,
                 resync_horizon=2)
    ref, port = make_pair(data, fkw, sim_kw(rounds=2, seed=3), HETERO)
    hr, hp = ref.run(), port.run()
    assert_runs_match(ref, port, hr, hp)
    assert_ef_close(ref, port)
    assert_bookkeeping_equal(ref, port)
    assert port.refs.catchups > 0 and port.refs.resyncs > 0
    ref, port = run_long_pair(data, fkw)
    assert port.staleness_hist.max >= 1
    assert port.refs.catchups > 2 and port.refs.resyncs > 1


class AsyncReferenceDraws:
    """The reference async engine's QSGD uniforms, served by name.  Uplink
    ``(dispatch, "uplink", path)``: fold_in(PRNGKey(seed ^ 0x5F5E1),
    dispatch) split over the group's clients, each client's key over the
    leaves in flatten order.  Downlink ``(version, "downlink", 0, path)``:
    fold_in(fold_in(fold_in(base, 0xB0), version), 0), split over the
    leaves.  Conv draws are carried to the port's OIHW layout."""

    def __init__(self, seed, params):
        self.base = jax.random.PRNGKey(seed ^ 0x5F5E1)
        paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(params)[0])
        self.order = ["/".join(k.key for k in path) for path in paths]
        shapes = [x.shape for x in leaves]
        n = len(shapes)
        self._leaves = jax.jit(lambda k: [
            jax.random.uniform(lk, shape)
            for lk, shape in zip(jax.random.split(k, n), shapes)])
        self._cache = {}

    def _draws(self, t, direction, k_clients):
        if direction == "uplink":
            gk = jax.random.fold_in(self.base, np.uint32(t))
            per = [self._leaves(ck) for ck in jax.random.split(gk, k_clients)]
            leaves = [np.stack([np.asarray(c[i]) for c in per])
                      for i in range(len(self.order))]
        else:
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.fold_in(self.base, np.uint32(0xB0)),
                np.uint32(t)), 0)
            leaves = [np.asarray(u)[None] for u in self._leaves(key)]
        return {p: u.transpose(0, 4, 3, 1, 2) if u.ndim == 5 else u
                for p, u in zip(self.order, leaves)}

    def __call__(self, name, shape, dtype, device):
        t, direction, path = name[0], name[1], name[-1]
        if (t, direction) not in self._cache:
            self._cache = {(t, direction): self._draws(t, direction,
                                                       shape[0])}
        return torch.from_numpy(
            np.array(self._cache[(t, direction)][path])).to(dtype)


def test_async_qsgd_wire_with_reference_draws(data):
    """QSGD 4 bits up with EF, delta+QSGD 8 bits down, every uniform the
    reference's own: the stochastic rounding sees the same draws, so two
    flushes agree at the one-round bar, EF residuals included.

    A rounding whose fraction lies within fp32 noise of its draw goes
    either way, and moves its element by a whole quantisation step.  Each
    dispatch rounds ~200k elements, so most runs meet one: at seed 1 one
    element of the 216 in c1/w after the first flush (every other element
    of every leaf agrees, so the draws are the reference's), and of seeds
    2 and 4-7 only 2, 5 and 6 reach two flushes without one (none reaches
    three with the EF residuals too).  The bookkeeping does not read the
    draws, so it is held exactly over eight flushes at seed 3, where a
    near-tie meets the first flush."""
    fkw = fed_kw(compressor="qsgd", qsgd_bits=4,
                 downlink_compressor="delta+qsgd", downlink_qsgd_bits=8)
    x, y, xt, yt, parts = data
    skw = sim_kw(rounds=2, seed=2)
    ref = JAsync(JFedConfig(**fkw), JSimConfig(**skw),
                 JHeteroConfig(**HETERO), x, y, xt, yt, parts)
    jparams = jax.tree.map(np.asarray, ref.params)
    port = AsyncFederatedSimulator(
        FedConfig(**fkw), SimConfig(**skw), HeteroConfig(**HETERO),
        x, y, xt, yt, parts, params=convert.from_numpy(jparams, "cpu"),
        device="cpu", uniforms=AsyncReferenceDraws(2, jparams))
    hr, hp = ref.run(), port.run()
    assert_runs_match(ref, port, hr, hp)
    assert_ef_close(ref, port)
    assert_bookkeeping_equal(ref, port)
    run_long_pair(data, fkw)


def test_async_sparse_wire_drop_folds_back_into_ef(data):
    """The sparse (value, index) wire with its sparse aggregate and drops:
    a dropped record is densified and folded back into its client's EF
    residual, as the reference does."""
    fkw = fed_kw(compressor="topk", topk_frac=0.1, sparse_uplink=True,
                 sparse_aggregate=True)
    hkw = dict(HETERO, drop_prob=0.3)
    ref, port = make_pair(data, fkw, sim_kw(rounds=4, seed=3), hkw)
    hr, hp = ref.run(), port.run()
    dropped = {c for kind, _, c, _ in port.event_log if kind == "drop"}
    assert dropped
    assert_runs_match(ref, port, hr, hp)
    assert_ef_close(ref, port)


@pytest.mark.parametrize("strategy", sorted(ASYNC_UNSUPPORTED))
def test_stateful_strategies_rejected(data, strategy):
    x, y, xt, yt, parts = data
    with pytest.raises(ValueError, match="stateless"):
        AsyncFederatedSimulator(FedConfig(**fed_kw(strategy=strategy)),
                                SimConfig(**sim_kw()), HeteroConfig(),
                                x, y, xt, yt, parts, device="cpu")


def test_fednova_scale_varies(data):
    """Variable local work: the FedNova factor H_ref/H_i differs between
    clients, equals the reference's per client, and the run stays on the
    reference's trajectory."""
    hkw = dict(enabled=True, local_steps_choices=(2, 8), fednova=True,
               seed=1)
    ref, port = make_pair(data, fed_kw(buffer_k=0, clients_per_round=3),
                          sim_kw(rounds=3), hkw)
    scales = [port.system.delta_scale(c) for c in range(port.n_clients)]
    assert len(set(scales)) > 1
    assert scales == [ref.system.delta_scale(c)
                      for c in range(ref.n_clients)]
    assert_runs_match(ref, port, ref.run(), port.run())


@pytest.mark.parametrize("strategy", ["fedavg", "fedadc"])
def test_hetero_off_equals_sync_simulator_bit_for_bit(data, strategy):
    """Heterogeneity off and buffer_k = 0: every wave arrives together,
    each flush has staleness 0 and scale 1, and the port's async engine
    gives the port's sync simulator's parameters bit for bit."""
    x, y, xt, yt, parts = data
    fed = FedConfig(**fed_kw(strategy=strategy, buffer_k=0,
                             clients_per_round=3))
    sim = SimConfig(**sim_kw(rounds=3))
    sync = FederatedSimulator(fed, sim, x, y, xt, yt, parts, device="cpu")
    asyn = AsyncFederatedSimulator(fed, sim, HeteroConfig(), x, y, xt, yt,
                                   parts, device="cpu")
    hs, ha = sync.run(), asyn.run()
    assert asyn.staleness_hist.max == 0 and asyn.staleness_hist.count == 9
    assert [h["round"] for h in hs] == [h["round"] for h in ha]
    for a, b in zip(hs, ha):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-6)
        assert a["acc"] == b["acc"]
    for a, b in zip(jax.tree.leaves(sync.params),
                    jax.tree.leaves(asyn.params)):
        assert torch.equal(a, b)


def test_deterministic_over_two_runs(data):
    x, y, xt, yt, parts = data
    runs = []
    for _ in range(2):
        e = AsyncFederatedSimulator(FedConfig(**fed_kw()),
                                    SimConfig(**sim_kw(rounds=3)),
                                    HeteroConfig(**HETERO), x, y, xt, yt,
                                    parts, device="cpu")
        h = e.run()
        runs.append((list(e.event_log), e.staleness_hist.to_dict(), list(h)))
    assert runs[0] == runs[1]
