"""The port's wire layer — codecs, transport, downlink reference and the
sparse aggregate — held against the JAX package's on the CPU.

Inputs come from numpy with a seed; the lossy downlink's QSGD draws are
the reference's own, computed with JAX from its keys and handed to the
port by leaf path.  Bars:

* wire bytes: equal to the reference's exactly, for every codec in
  ``KNOWN_DOWNLINK`` and ``KNOWN_COMPRESSORS``, and the simulators'
  measured downlink bytes and unicast ledgers equal too;
* lossless codecs (``identity``, ``delta``, ``delta+identity``): runs bit
  for bit equal to ``none``; unicast under full participation equal to
  multicast, in bytes and bit for bit in parameters;
* lossy broadcasts against the reference's: top-k bit for bit, QSGD within
  1e-5 of each leaf's scale (every op rounds in fp32 on both sides, but
  XLA may fuse where torch does not);
* the sparse-native aggregate bit for bit equal to decoding each client
  and folding in order, and the sparse DRAG helpers within 1e-6 of the
  reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core import strategies as JS
from repro.data.partition import sort_and_partition
from repro.data.synthetic import make_image_dataset
from repro.federated import aggregation as JA
from repro.federated import transport as JT
from repro.federated.compression import SparseLeaf as JSparseLeaf
from repro.federated.protocol import RoundProtocol as JRoundProtocol
from repro.federated.simulator import FederatedSimulator as JSim
from repro.federated.simulator import SimConfig as JSimConfig
from repro.models.vision import cnn_init as jcnn_init
from repro_torch import convert
from repro_torch.configs.base import FedConfig
from repro_torch.core import strategies as S
from repro_torch.core import tree as T
from repro_torch.federated import aggregation as A
from repro_torch.federated import compression as C
from repro_torch.federated import transport as TR
from repro_torch.federated.protocol import RoundProtocol
from repro_torch.federated.simulator import FederatedSimulator, SimConfig


def params_pair(seed, width=4):
    """Random CNN parameters as (JAX layout numpy tree, port tensors)."""
    shapes = jax.eval_shape(lambda: jcnn_init(
        jax.random.PRNGKey(0), n_classes=10, width=width, image_size=16))
    rng = np.random.RandomState(seed)
    jp = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32),
                      shapes)
    return jp, convert.from_numpy(jp, "cpu")


def jax_order(tree):
    paths, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path) for path, _ in paths]


def to_port_layout(u):
    return u.transpose(3, 2, 0, 1) if u.ndim == 4 else u


class KeyDraws:
    """The uniforms the reference draws from `key` for a tree, split over
    its leaves in flatten order, served to the port by key path.  `names`
    maps the port's path to the reference's flatten-order path."""

    def __init__(self, key, jtree, names=lambda p: p):
        order = jax_order(jtree)
        keys = jax.random.split(key, len(order))
        self.u = {p: np.asarray(jax.random.uniform(k, leaf.shape))
                  for p, k, leaf in zip(order, keys, jax.tree.leaves(jtree))}
        self.names = names

    def __call__(self, name, shape, dtype, device):
        u = to_port_layout(self.u[self.names(name[-1])])
        return torch.from_numpy(np.array(u)).reshape(shape)


def fedadc_ctx_pair(jp, tp, seed, strategy="fedadc"):
    """A random fp32 server momentum through both strategies' client_setup
    -> (reference ctx, port ctx)."""
    rng = np.random.RandomState(seed)
    jm = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), jp)
    fed, jfed = FedConfig(strategy=strategy), JFedConfig(strategy=strategy)
    jctx = JS.get_strategy(strategy).client_setup({"m": jm}, jp, jfed)
    tctx = S.get_strategy(strategy).client_setup(
        {"m": convert.from_numpy(jm, "cpu")}, tp, fed)
    return jctx, tctx


def assert_tree_close(port_tree, ref_tree, tol):
    got = convert.to_numpy(port_tree)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(ref_tree)):
        w = np.asarray(w)
        if tol == 0:
            np.testing.assert_array_equal(g, w)
        else:
            scale = np.abs(w).max() + 1e-12
            np.testing.assert_allclose(g / scale, w / scale, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec", JT.KNOWN_DOWNLINK)
@pytest.mark.parametrize("strategy", ["fedadc", "fedavg"])
def test_downlink_bytes_match_reference(codec, strategy):
    jp, tp = params_pair(0, width=32)
    jctx, tctx = (fedadc_ctx_pair(jp, tp, 1) if strategy == "fedadc"
                  else (None, {}))
    kw = dict(strategy=strategy, downlink_compressor=codec,
              downlink_topk_frac=0.05, downlink_qsgd_bits=6)
    assert TR.downlink_nbytes(FedConfig(**kw), tp, tctx) == \
        JT.downlink_nbytes(JFedConfig(**kw), jp, jctx)


@pytest.mark.parametrize("compressor,sparse", [
    ("none", False), ("identity", False), ("topk", False), ("topk", True),
    ("qsgd", False)])
def test_uplink_bytes_match_reference(compressor, sparse):
    jp, tp = params_pair(0, width=32)
    kw = dict(compressor=compressor, sparse_uplink=sparse, topk_frac=0.1,
              qsgd_bits=4)
    assert TR.Transport(FedConfig(**kw)).uplink_wire_nbytes(tp) == \
        JT.Transport(JFedConfig(**kw)).uplink_wire_nbytes(jp)


# ---------------------------------------------------------------------------
# the lossy downlink against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("codec,tol", [("topk", 0), ("qsgd", 1e-5)])
def test_stateless_lossy_broadcast_matches_reference(codec, tol):
    jp, tp = params_pair(2)
    jctx, tctx = fedadc_ctx_pair(jp, tp, 3)
    kw = dict(downlink_compressor=codec, downlink_topk_frac=0.1,
              downlink_qsgd_bits=4)
    key = jax.random.PRNGKey(11)
    jpw, jcw, _ = JT.Transport(JFedConfig(**kw)).broadcast(jp, jctx, key)
    draws = C.UniformDraws(KeyDraws(key, (jp, jctx), lambda p: p.replace(
        "params/", "0/", 1).replace("ctx/", "1/", 1)), (), "cpu")
    tpw, tcw, ref = TR.Transport(FedConfig(**kw)).broadcast(tp, tctx, draws)
    assert ref is None
    assert_tree_close(tpw, jpw, tol)
    assert_tree_close(tcw, jcw, tol)


@pytest.mark.parametrize("codec,tol", [("delta+topk", 0),
                                       ("delta+qsgd", 1e-5)])
@pytest.mark.parametrize("strategy", ["fedadc", "fedadc_double", "fedavg"])
def test_delta_broadcast_chain_matches_reference(codec, tol, strategy):
    """Three broadcasts, each coded against the reconstruction the last one
    left: the ctx is derived from the θ wire for the FedADC family, and
    the references advance alike."""
    kw = dict(strategy=strategy, downlink_compressor=codec,
              downlink_topk_frac=0.2, downlink_qsgd_bits=5, eta=0.05)
    jtr, ttr = JT.Transport(JFedConfig(**kw)), TR.Transport(FedConfig(**kw))
    jp, tp = params_pair(4)
    if strategy == "fedavg":
        jctx, tctx = None, {}
    else:
        jctx, tctx = fedadc_ctx_pair(jp, tp, 5, strategy)
    jref, tref = jtr.init_downlink_ref(jp, jctx), ttr.init_downlink_ref(tp,
                                                                       tctx)
    for step in range(3):
        jp, tp = params_pair(10 + step)
        if strategy != "fedavg":
            jctx, tctx = fedadc_ctx_pair(jp, tp, 20 + step, strategy)
        key = jax.random.PRNGKey(30 + step)
        jpw, jcw, jref = jtr.broadcast(jp, jctx, key, jref)
        draws = C.UniformDraws(KeyDraws(jax.random.fold_in(key, 0), jp),
                               (), "cpu")
        tpw, tcw, tref = ttr.broadcast(tp, tctx, draws, tref)
        assert_tree_close(tpw, jpw, tol)
        assert_tree_close(tref[0], jref[0], tol)
        if strategy != "fedavg":
            assert_tree_close(tcw, jcw, tol)
            assert_tree_close(tref[1], jref[1], tol)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("strategy", ["scaffold", "feddyn"])
@pytest.mark.parametrize("kw,match", [
    ({"compressor": "topk"}, "compressor='topk' is not supported"),
    ({"compressor": "qsgd"}, "compressor='qsgd' is not supported"),
    ({"downlink_compressor": "qsgd"}, "carries its server correction"),
    ({"downlink_compressor": "delta+topk"}, "carries its server correction"),
])
def test_stateful_strategies_reject_lossy_wires(strategy, kw, match):
    for fed_cls, make in ((FedConfig, RoundProtocol),
                          (JFedConfig, JRoundProtocol)):
        with pytest.raises(ValueError, match=match):
            make(fed_cls(strategy=strategy, **kw))


@pytest.mark.parametrize("kw,match", [
    ({"compressor": "delta"}, "downlink"),
    ({"downlink_compressor": "delta+none"}, "unknown downlink"),
    ({"downlink_compressor": "zip"}, "unknown downlink"),
    ({"compressor": "qsgd", "sparse_uplink": True}, "sparse_uplink"),
    ({"downlink_unicast": True}, "lossless delta"),
    ({"downlink_compressor": "delta+topk", "downlink_unicast": True},
     "lossless delta"),
    ({"downlink_compressor": "delta", "downlink_unicast": True,
      "resync_horizon": -1}, "resync_horizon"),
])
def test_codec_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        TR.Transport(FedConfig(**kw))
    with pytest.raises(ValueError, match=match):
        JT.Transport(JFedConfig(**kw))


def test_lossy_broadcast_needs_draws_and_reference():
    _, tp = params_pair(0)
    with pytest.raises(ValueError, match="draws"):
        TR.Transport(FedConfig(downlink_compressor="qsgd")).broadcast(tp, {})
    draws = C.UniformDraws(C.GeneratorUniforms(0, "cpu"), (), "cpu")
    with pytest.raises(ValueError, match="stateful"):
        TR.Transport(FedConfig(downlink_compressor="delta+qsgd")).broadcast(
            tp, {}, draws)


# ---------------------------------------------------------------------------
# the sparse-native aggregate
# ---------------------------------------------------------------------------
def stacked_pair(seed, K):
    jp, tp = params_pair(seed)
    rng = np.random.RandomState(seed)
    jd = jax.tree.map(lambda a: rng.randn(K, *a.shape).astype(np.float32),
                      jp)
    td = T.tree_map(lambda t: torch.from_numpy(rng.randn(
        K, *t.shape).astype(np.float32)), tp)
    return jd, td, tp


def test_sparse_aggregate_equals_dense_decode():
    """Encode-only plus the sparse aggregate equals the round trip plus the
    dense weighted mean, bit for bit, and both leave the same EF."""
    K = 5
    _, deltas, params = stacked_pair(6, K)
    efs = T.scale(deltas, 0.1)
    proto = RoundProtocol(FedConfig(compressor="topk", sparse_uplink=True,
                                    topk_frac=0.05, aggregator="examples"))
    assert proto.sparse_native
    wire, ef_a = proto.uplink_encode(deltas, efs)
    dense, ef_b = proto.uplink(deltas, efs)
    assert C.is_sparse_tree(wire) and not C.is_sparse_tree(dense)
    w = torch.tensor([3.0, 1.0, 2.0, 5.0, 4.0])
    sparse_mean = proto.aggregate(wire, proto.weights(wire, w, like=params),
                                  like=params)
    dense_mean = proto.aggregate(dense, proto.weights(dense, w))
    for a, b in zip(T.leaves(sparse_mean), T.leaves(dense_mean)):
        assert torch.equal(a, b)
    for a, b in zip(T.leaves(ef_a), T.leaves(ef_b)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="like="):
        proto.aggregate(wire, w)


def test_sparse_drag_helpers_match_reference():
    """The port's helpers read the sparse wire; the reference's read the
    same deltas as a wire that lists every index (JAX layout), so the
    values agree and only the summation order differs."""
    K = 4
    _, td, tp = stacked_pair(7, K)
    fed = FedConfig(compressor="topk", sparse_uplink=True, topk_frac=0.1)
    tr = TR.Transport(fed)
    wire, _ = tr.uplink_encode(td, T.zeros_like(td))
    dense = tr.uplink_decode(wire, td)
    per_client = [convert.to_numpy(T.tree_map(lambda d: d[k], dense))
                  for k in range(K)]
    jw = jax.tree.map(
        lambda *ds: JSparseLeaf(
            jnp.asarray(np.stack([d.reshape(-1) for d in ds])),
            jnp.tile(jnp.arange(ds[0].size, dtype=jnp.int32), (K, 1))),
        *per_client)
    jref, ref = params_pair(8)
    jlike = jax.tree.map(jnp.asarray, jref)
    np.testing.assert_allclose(A.sparse_sq_norms(wire).numpy(),
                               np.asarray(JA.sparse_sq_norms(jw)), rtol=1e-6)
    np.testing.assert_allclose(A.sparse_dot_dense(wire, ref).numpy(),
                               np.asarray(JA.sparse_dot_dense(jw, jlike)),
                               rtol=1e-5, atol=1e-5)
    for r_t, r_j in ((ref, jlike), (None, None)):
        got = A.compute_weights("drag", wire, ref=r_t, like=tp)
        want = JA.compute_weights("drag", jw, ref=r_j, like=jlike)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# simulator-level: lossless codecs, unicast
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def data():
    x, y, xt, yt = make_image_dataset(600, 100, 10, image_size=16, seed=0,
                                      noise=0.5)
    parts = sort_and_partition(y, 10, s=2, seed=0)
    return x, y, xt, yt, parts


def run_port(data, rounds=2, **kw):
    x, y, xt, yt, parts = data
    fed = FedConfig(**{**dict(local_steps=2, clients_per_round=3,
                              n_clients=10, eta=0.03), **kw})
    s = FederatedSimulator(fed, SimConfig(batch_size=16, rounds=rounds,
                                          eval_every=rounds, cnn_width=8,
                                          seed=2),
                           x, y, xt, yt, parts, device="cpu")
    s.run()
    return s


def params_equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(T.leaves(a.params),
                                                 T.leaves(b.params)))


def test_lossless_codecs_equal_none_bitwise(data):
    base = run_port(data)
    for kw in ({"compressor": "identity"},
               {"downlink_compressor": "identity"},
               {"downlink_compressor": "delta"},
               {"downlink_compressor": "delta+identity"},
               {"downlink_compressor": "delta", "downlink_unicast": True}):
        assert params_equal(run_port(data, **kw), base), kw


def test_unicast_full_participation_equals_multicast(data):
    kw = dict(downlink_compressor="delta", clients_per_round=10)
    multi = run_port(data, rounds=3, **kw)
    uni = run_port(data, rounds=3, downlink_unicast=True, **kw)
    assert params_equal(multi, uni)
    assert uni.downlink_bytes == multi.downlink_bytes > 0
    assert uni.downlink_bytes_raw == multi.downlink_bytes_raw


def test_unicast_ledgers_match_reference(data):
    """Partial participation over 5 rounds at horizon 1: the port's
    measured bytes, catch-ups, resyncs and per-client ledgers equal the
    reference's, and each dispatched client's page holds its wire."""
    x, y, xt, yt, parts = data
    kw = dict(local_steps=2, clients_per_round=3, n_clients=10, eta=0.03,
              downlink_compressor="delta", downlink_unicast=True,
              resync_horizon=1)
    sim = dict(batch_size=16, rounds=5, eval_every=5, cnn_width=8, seed=2)
    ref = JSim(JFedConfig(**kw), JSimConfig(**sim), x, y, xt, yt, parts)
    port = FederatedSimulator(FedConfig(**kw), SimConfig(**sim), x, y, xt,
                              yt, parts, device="cpu")
    ref.run()
    port.run()
    for attr in ("downlink_bytes", "downlink_bytes_raw", "uplink_bytes"):
        assert getattr(port, attr) == getattr(ref, attr), attr
    assert port.refs.catchups == ref.refs.catchups
    assert port.refs.resyncs == ref.refs.resyncs
    assert port.refs.catchups + port.refs.resyncs > 0
    for ledger in ("client_bytes", "client_catchups", "client_resyncs"):
        assert getattr(port.refs, ledger) == getattr(ref.refs, ledger)
    hist = port.telemetry.histograms["downlink.client_kb"]
    assert hist.count == 5 * 3
    for c in port.refs.client_bytes:
        page = port.refs.client_reference(c)
        assert page is not None and T.leaves(page[0])[0].shape == \
            T.leaves(port.params)[0].shape
    assert port.refs.client_reference(10_000) is None
    for c in port.refs.client_bytes:
        assert port.refs.client_staleness(c, 5) == \
            ref.refs.client_staleness(c, 5)
    assert port.refs.client_staleness(10_000, 5) is None
