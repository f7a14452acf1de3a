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
two fp32 implementations can agree there.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import FedConfig as JFedConfig
from repro.data.partition import sort_and_partition
from repro.data.synthetic import make_image_dataset
from repro.federated.simulator import FederatedSimulator as JSim
from repro.federated.simulator import SimConfig as JSimConfig
from repro_torch import convert
from repro_torch.configs.base import FedConfig
from repro_torch.federated.simulator import FederatedSimulator, SimConfig


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
    ref.run()
    port.run()
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


@pytest.mark.parametrize("kw", [
    {"strategy": "moon"}, {"strategy": "fedrs"}, {"distill": True},
    {"compressor": "topk"}, {"downlink_compressor": "delta"},
    {"fleet_regions": 2}, {"downlink_unicast": True},
])
def test_unported_configs_raise(data, kw):
    x, y, xt, yt, parts = data
    with pytest.raises(NotImplementedError):
        FederatedSimulator(FedConfig(**kw), SimConfig(cnn_width=8), x, y, xt,
                           yt, parts, device="cpu")
