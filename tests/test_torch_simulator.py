"""The port's synchronous simulator against the JAX package's, on
``test_simulator.py``'s fixture (1200/300 images at 16x16, N=10, |S|=3,
H=4, batch 16, cnn_width=8, seed 1).

Both engines start from the reference's own init (converted with
``repro_torch.convert``) and draw picks and batches from the same
``RandomState`` stream.  Bars, relative to each leaf's scale:

* one round: parameters within 1e-5 and the loss within 1e-5;
* twelve rounds: parameters within 1e-3, per-eval loss within 1e-3,
  accuracy within 0.02.

Multi-round FedADC and one-round FedDyn run at seed 2.  At seed 1 the
reference's init puts them on a branch point (FedADC in its second round,
FedDyn in its first): the port against itself, with its initial parameters
perturbed by 1e-7 relative, ends as far apart (1e-2 after one FedDyn
round, ~1.0 after 12 FedADC rounds) as it ends from the reference, so no
two fp32 implementations can agree there.  Multi-round FedADC+ runs at
seed 1: at seed 2 it meets a branch point of the same kind (the port
against itself, perturbed by 1e-7 relative, 1.6e-2 apart after 12 rounds;
1.1e-2 from the reference).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.data.partition import sort_and_partition
from repro.data.synthetic import make_image_dataset
from repro.federated.simulator import FederatedSimulator as JSim
from repro.federated.simulator import SimConfig as JSimConfig
from repro_torch import convert
from repro_torch.configs.base import FedConfig
from repro_torch.federated.simulator import FederatedSimulator, SimConfig

from _fixtures import shared_reference_jits  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def data():
    x, y, xt, yt = make_image_dataset(1200, 300, 10, image_size=16, seed=0,
                                      noise=0.5)
    parts = sort_and_partition(y, 10, s=2, seed=0)
    return x, y, xt, yt, parts


def make_pair(data, strategy, rounds, seed=1, **fed_kw):
    x, y, xt, yt, parts = data
    kw = dict(strategy=strategy, local_steps=4, clients_per_round=3,
              n_clients=10, eta=0.03, beta_global=0.6, beta_local=0.6)
    kw.update(fed_kw)
    sim = dict(model="cnn", n_classes=10, batch_size=16, rounds=rounds,
               eval_every=rounds, cnn_width=8, seed=seed)
    ref = JSim(JFedConfig(**kw), JSimConfig(**sim), x, y, xt, yt, parts)
    params = convert.from_numpy(jax.tree.map(np.asarray, ref.params), "cpu")
    kw.pop("use_pallas", None)
    port = FederatedSimulator(FedConfig(**kw), SimConfig(**sim), x, y, xt,
                              yt, parts, params=params, device="cpu")
    return ref, port


def assert_params_close(ref, port, tol):
    want = jax.tree.map(np.asarray, ref.params)
    got = convert.to_numpy(port.params)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / scale, w / scale, atol=tol, rtol=0)


def assert_history_close(ref, port, loss_tol, acc_tol):
    assert len(ref.history) == len(port.history)
    for a, b in zip(ref.history, port.history):
        assert a["round"] == b["round"]
        assert abs(a["loss"] - b["loss"]) <= loss_tol * abs(a["loss"])
        assert abs(a["acc"] - b["acc"]) <= acc_tol


@pytest.mark.parametrize("strategy,kw", [
    ("fedavg", {}),
    ("fedadc", {"variant": "nesterov"}),
    ("fedadc", {"variant": "heavyball"}),
    ("scaffold", {}),
    ("feddyn", {"seed": 2}),
])
def test_one_round(data, strategy, kw):
    ref, port = make_pair(data, strategy, rounds=1, **kw)
    aggregates = []
    aggregate = port.protocol.aggregate
    port.protocol.aggregate = \
        lambda *a, **k: aggregates.append(1) or aggregate(*a, **k)
    ref.run()
    port.run()
    # one aggregate a round (one weighted_reduce launch on the card), none
    # for FedDyn, whose server step reads no mean delta
    assert len(aggregates) == (0 if strategy == "feddyn" else 1)
    assert_params_close(ref, port, 1e-5)
    assert_history_close(ref, port, 1e-5, 0.0)
    assert (port.uplink_bytes, port.downlink_bytes) == (ref.uplink_bytes,
                                                        ref.downlink_bytes)
    if strategy in ("scaffold", "feddyn"):
        assert sorted(port.client_states) == sorted(ref.client_states)


@pytest.mark.parametrize("strategy,seed", [("fedavg", 1), ("fedadc", 2)])
def test_twelve_rounds(data, strategy, seed):
    ref, port = make_pair(data, strategy, rounds=12, seed=seed)
    ref.run()
    port.run()
    assert_params_close(ref, port, 1e-3)
    assert_history_close(ref, port, 1e-3, 0.02)


# ---------------------------------------------------------------------------
# FedADC+ and the loss-modifier baselines (the paper's Table I)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy,kw", [
    ("fedadc", {"distill": True, "variant": "nesterov"}),
    ("fedadc", {"distill": True, "variant": "heavyball"}),
    ("fedadc", {"distill": True, "distill_lambda": 0.7, "distill_tau": 2.0}),
    # distill takes precedence over the strategy's own loss
    ("fedavg", {"distill": True}),
    ("fedgkd", {}),
    ("fedntd", {}),
    ("fedrs", {}),
])
def test_loss_modifiers_one_round(data, strategy, kw):
    """FedADC+ (the self-confidence KD through the KD kernel's vmapped
    Functions) and the FedGKD, FedNTD and FedRS losses: one round at the
    one-round bar."""
    ref, port = make_pair(data, strategy, rounds=1, **kw)
    ref.run()
    port.run()
    assert_params_close(ref, port, 1e-5)
    assert_history_close(ref, port, 1e-5, 0.0)


def test_moon_two_rounds(data):
    """MOON keeps each client's previous local model in the client store:
    two rounds, a client picked in both, so its state round-trips; the
    stored states match the reference's at the one-round bar."""
    ref, port = make_pair(data, "moon", rounds=2)
    ref.run()
    port.run()
    assert_params_close(ref, port, 1e-5)
    assert_history_close(ref, port, 1e-5, 0.0)
    assert sorted(port.client_states) == sorted(ref.client_states)
    # 3 picks a round over 2 rounds: fewer than 6 states means a repeat
    assert len(port.client_states) < 6
    for c, st in port.client_states.items():
        got = convert.to_numpy(st["prev"])
        want = jax.tree.map(np.asarray, ref.client_states[c]["prev"])
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            scale = np.abs(w).max() + 1e-12
            np.testing.assert_allclose(g / scale, w / scale, atol=1e-5,
                                       rtol=0)


def test_fedadc_plus_twelve_rounds(data):
    """Twelve FedADC+ rounds at the multi-round bar (seed 1; see the module
    docstring for seed 2)."""
    ref, port = make_pair(data, "fedadc", rounds=12, distill=True)
    ref.run()
    port.run()
    assert_params_close(ref, port, 1e-3)
    assert_history_close(ref, port, 1e-3, 0.02)


def test_three_rounds_against_pallas_reference(data):
    """The reference with its Pallas update kernels (interpret mode)."""
    ref, port = make_pair(data, "fedadc", rounds=3, seed=2, use_pallas=True)
    ref.run()
    port.run()
    assert_params_close(ref, port, 1e-5)
    assert_history_close(ref, port, 1e-5, 0.0)


def test_identity_wire_equals_bypass(data):
    """The identity codec passes the trees untouched: bit-identical params
    and the same (raw) byte counts as the bypass."""
    x, y, xt, yt, parts = data
    runs = []
    for codec in ("none", "identity"):
        fed = FedConfig(local_steps=2, clients_per_round=3, n_clients=10,
                        eta=0.03, compressor=codec, downlink_compressor=codec)
        sim = SimConfig(batch_size=16, rounds=2, eval_every=2, cnn_width=8,
                        seed=1)
        s = FederatedSimulator(fed, sim, x, y, xt, yt, parts, device="cpu")
        s.run()
        runs.append(s)
    a, b = runs
    for u, v in zip(convert.to_numpy(a.params).values(),
                    convert.to_numpy(b.params).values()):
        jax.tree.map(np.testing.assert_array_equal, u, v)
    assert a.uplink_bytes == b.uplink_bytes == b.uplink_bytes_raw > 0
    assert a.downlink_bytes == b.downlink_bytes == b.downlink_bytes_raw > 0


# ---------------------------------------------------------------------------
# the compressed wire
# ---------------------------------------------------------------------------
class ReferenceDraws:
    """The reference simulator's own QSGD uniforms, served to the port by
    name (round, "uplink" | "downlink", ..., leaf path).  The reference
    keys round t with fold_in(PRNGKey(seed ^ 0x5F5E1), t); the uplink
    splits that key over the K clients and each client's key over the
    leaves in flatten order; the delta downlink folds in 0xD0, then 0 for
    θ.  Conv draws are carried to the port's OIHW layout."""

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
        rk = jax.random.fold_in(self.base, np.uint32(t))
        if direction == "uplink":
            per = [self._leaves(ck) for ck in jax.random.split(rk, k_clients)]
            leaves = [np.stack([np.asarray(c[i]) for c in per])
                      for i in range(len(self.order))]
        else:
            key = jax.random.fold_in(jax.random.fold_in(rk, 0xD0), 0)
            leaves = [np.asarray(u)[None] for u in self._leaves(key)]
        return {p: u.transpose(0, 4, 3, 1, 2) if u.ndim == 5 else u
                for p, u in zip(self.order, leaves)}

    def __call__(self, name, shape, dtype, device):
        t, direction, path = name[0], name[1], name[-1]
        if (t, direction) not in self._cache:
            self._cache = {(t, direction): self._draws(t, direction,
                                                       shape[0])}
        u = self._cache[(t, direction)][path]
        return torch.from_numpy(np.array(u)).to(dtype)


WIRES = {
    "topk_ef": dict(compressor="topk", topk_frac=0.1),
    "topk_sparse": dict(compressor="topk", topk_frac=0.1, sparse_uplink=True,
                        sparse_aggregate=True),
    "qsgd_delta_qsgd": dict(compressor="qsgd", qsgd_bits=4,
                            downlink_compressor="delta+qsgd",
                            downlink_qsgd_bits=8),
}


def sync_port_to_reference(port, ref):
    """Give the port the reference's round state: parameters, server
    momentum, EF residuals and the delta downlink's reference."""
    port.params = convert.from_numpy(jax.tree.map(np.asarray, ref.params),
                                     "cpu")
    port.server_state = {"m": convert.from_numpy(
        jax.tree.map(np.asarray, ref.server_state["m"]), "cpu")}
    for c, ef in ref.ef_states.items():
        port.ef_states[c] = convert.from_numpy(jax.tree.map(np.asarray, ef),
                                               "cpu")
    if ref.refs.reference() is not None:
        jp, jc = ref.refs.reference()
        port.refs.seed((convert.from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"),
                        {"m_bar": convert.from_numpy(jax.tree.map(
                            np.asarray, jc["m_bar"]), "cpu")}))


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_wire_rounds_match_reference(data, wire):
    """Three FedADC rounds on each compressed wire, with the reference's own
    draws.  Each round starts both engines from the reference's state: a
    top-k selection or a stochastic rounding near its boundary may flip on
    a 1e-7 difference and move one entry by a whole step, so errors are
    held per round, not compounded.  Bars: parameters and loss within PR
    11's one-round 1e-5 of each leaf's scale; the EF residuals within 1e-4
    of their parameter leaf's scale, since a residual is one client's delta
    unaveraged and carries that client's local-training error (measured up
    to 1.6e-5); the measured bytes equal.

    Seed 3: at seed 2 the top-k wires reach a branch point in round 2,
    where the port against itself, parameters perturbed by 1e-7 relative,
    moves one client's delta by 4% (as seed 1 does for FedADC without a
    wire, noted above)."""
    x, y, xt, yt, parts = data
    kw = dict(strategy="fedadc", local_steps=4, clients_per_round=3,
              n_clients=10, eta=0.03, beta_global=0.6, beta_local=0.6,
              **WIRES[wire])
    sim = dict(model="cnn", n_classes=10, batch_size=16, rounds=1,
               eval_every=1, cnn_width=8, seed=3)
    ref = JSim(JFedConfig(**kw), JSimConfig(**sim), x, y, xt, yt, parts)
    jparams = jax.tree.map(np.asarray, ref.params)
    # the reference keys every run() call's first round with t = 0
    draws = ReferenceDraws(3, jparams)
    port = FederatedSimulator(FedConfig(**kw), SimConfig(**sim), x, y, xt,
                              yt, parts,
                              params=convert.from_numpy(jparams, "cpu"),
                              device="cpu",
                              uniforms=lambda name, *a: draws((0,) + name[1:],
                                                              *a))
    for r in range(3):
        sync_port_to_reference(port, ref)
        ref.run()
        port.run()
        assert_params_close(ref, port, 1e-5)
        assert_history_close(ref, port, 1e-5, 0.0)
        assert sorted(port.ef_states) == sorted(ref.ef_states)
        scales = [np.abs(np.asarray(p)).max()
                  for p in jax.tree.leaves(ref.params)]
        for c, ef in port.ef_states.items():
            for g, w, sc in zip(jax.tree.leaves(convert.to_numpy(ef)),
                                jax.tree.leaves(ref.ef_states[c]), scales):
                np.testing.assert_allclose(g, np.asarray(w), atol=1e-4 * sc,
                                           rtol=0)
    for attr in ("uplink_bytes", "uplink_bytes_raw", "downlink_bytes",
                 "downlink_bytes_raw"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.uplink_bytes < port.uplink_bytes_raw


def test_dense_and_sparse_topk_agree(data):
    """The dense threshold wire and the sparse (value, index) wire with its
    sparse aggregate give the same first-round update from the same state,
    within 1e-3 relative: the reconstructions are equal except where
    magnitudes tie at the threshold (the dense select keeps every tied
    entry, the sparse wire exactly k), and both aggregates sum in fp32 in
    client order.  Later rounds may part further, since a tie changes the
    EF residual the next round selects from."""
    x, y, xt, yt, parts = data
    updates, nbytes = [], []
    for kw in (WIRES["topk_ef"], WIRES["topk_sparse"]):
        fed = FedConfig(local_steps=2, clients_per_round=3, n_clients=10,
                        eta=0.03, **kw)
        s = FederatedSimulator(fed, SimConfig(batch_size=16, cnn_width=8,
                                              seed=2),
                               x, y, xt, yt, parts, device="cpu")
        start = {k: {j: t.clone() for j, t in v.items()}
                 for k, v in s.params.items()}
        s.run_round(*s.next_round_inputs())
        updates.append([a - b for a, b in zip(
            jax.tree.leaves(s.params), jax.tree.leaves(start))])
        nbytes.append(s.uplink_bytes)
    num = sum(float(((a - b) ** 2).sum()) for a, b in zip(*updates))
    den = sum(float((a ** 2).sum()) for a in updates[0])
    assert np.sqrt(num / den) <= 1e-3
    assert nbytes[0] == nbytes[1] > 0


@pytest.mark.parametrize("kw", [
    {"compressor": "topk"}, {"compressor": "qsgd"},
    {"compressor": "topk", "sparse_uplink": True},
    {"downlink_compressor": "topk"}, {"downlink_compressor": "qsgd"},
    {"downlink_compressor": "delta"}, {"downlink_compressor": "delta+topk"},
    {"downlink_compressor": "delta+qsgd"},
    {"downlink_compressor": "delta", "downlink_unicast": True},
    {"downlink_compressor": "delta+identity", "downlink_unicast": True},
])
def test_wire_configs_run(data, kw):
    """Every wire the reference's simulator runs, the port runs: one round,
    finite loss, measured bytes at most raw."""
    x, y, xt, yt, parts = data
    s = FederatedSimulator(FedConfig(local_steps=1, clients_per_round=3,
                                     n_clients=10, eta=0.03, **kw),
                           SimConfig(batch_size=16, rounds=1, eval_every=1,
                                     cnn_width=8, seed=2),
                           x, y, xt, yt, parts, device="cpu")
    hist = s.run()
    assert np.isfinite(hist[-1]["loss"])
    assert 0 < s.uplink_bytes <= s.uplink_bytes_raw
    assert 0 < s.downlink_bytes <= s.downlink_bytes_raw
