"""One local step and one server update per strategy class, the port
against the JAX package, plus the dense aggregators.

The port's local steps work on client-stacked trees (leading axis K); the
reference steps one client at a time, so each client's slice is compared
with the reference's step on that client.  Every gradient is a fixed numpy
array handed to both sides.  Bar: 1e-6 relative to each leaf's scale.  The
heavy-ball step with weight decay and clip folds both into g before the
fused kernel, η·((wd·θ + g) + m̄), where the reference computes
η·(wd·θ + (g + m̄)); the sums associate differently, so that case is held to
the same 1e-6 bar but not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FedConfig as JFedConfig
from repro.core import strategies as JS
from repro.federated import aggregation as JA
from repro_torch.configs.base import FedConfig
from repro_torch.core import strategies as S
from repro_torch.core import tree as T
from repro_torch.federated import aggregation as A

K = 3
SHAPES = {"c1": {"w": (4, 3, 3, 3), "b": (4,)}, "head": {"w": (6, 5)}}


def tree_np(seed, lead=()):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.randn(*(lead + s)).astype(np.float32),
                        SHAPES, is_leaf=lambda s: isinstance(s, tuple))


def to_t(t):
    return T.tree_map(torch.from_numpy, t)


def client(t, i):
    return jax.tree.map(lambda x: jnp.asarray(x[i]), t)


def assert_close(got, want, tol=1e-6):
    want = jax.tree.map(np.asarray, want)
    got = T.tree_map(lambda x: x.numpy(), got)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / scale, w / scale, atol=tol, rtol=0)


CASES = [
    ("fedavg", {}),
    ("slowmo", {}),
    ("fedadc", {"variant": "nesterov"}),
    ("fedadc", {"variant": "heavyball"}),
    ("fedadc", {"variant": "heavyball", "weight_decay": 1e-2,
                "grad_clip": 0.5}),
    ("fedadc", {"variant": "nesterov", "weight_decay": 1e-2,
                "grad_clip": 0.5}),
    ("fedadc_double", {}),
    ("fedprox", {}),
    ("scaffold", {}),
    ("feddyn", {}),
]


def server_state_np(strategy, seed):
    """A non-zero server state of the strategy's own structure."""
    st = JS.get_strategy(strategy).server_init(tree_np(0))
    return {k: tree_np(seed) for k in st}


@pytest.mark.parametrize("strategy,kw", CASES)
def test_local_steps(strategy, kw):
    """Two local steps (FedADCDouble's EMA starts at the second), each on
    its own fixed gradient."""
    base = dict(strategy=strategy, local_steps=4, eta=0.05, beta_global=0.7,
                beta_local=0.6, **kw)
    jfed, fed = JFedConfig(**base), FedConfig(**base)
    js, ts = JS.get_strategy(strategy), S.get_strategy(strategy)
    params = tree_np(1)
    ss = server_state_np(strategy, 2)
    jctx = js.client_setup(jax.tree.map(jnp.asarray, ss),
                           jax.tree.map(jnp.asarray, params), jfed)
    ctx = ts.client_setup(to_t(ss), to_t(params), fed)
    theta_k = tree_np(3, (K,))
    grads = [tree_np(10 + s, (K,)) for s in range(2)]
    cstate_k = tree_np(4, (K,))
    stateful = hasattr(ts, "client_state_init")
    # the one key of a stateful strategy's client state ("c_i", "grad_corr")
    name = next(iter(js.client_state_init(params))) if stateful else None

    def stack(t):
        return t.expand((K,) + t.shape).contiguous()
    ctx_k = T.tree_map(stack, ctx)
    theta = to_t(theta_k)
    extra = ({name: to_t(cstate_k)} if stateful
             else ts.init_extra(theta, fed))
    for g in grads:
        theta, extra, _ = ts.local_step(theta, ctx_k,
                                        lambda th, b, g=g: (to_t(g), 0.0),
                                        None, fed, extra)
    for i in range(K):
        th = client(theta_k, i)
        if stateful:
            ex = {name: client(cstate_k, i)}
        else:
            ex = js.init_extra(th, jfed)
        for g in grads:
            th, ex, _ = js.local_step(th, jctx,
                                      lambda t, b, g=g: (client(g, i), 0.0),
                                      None, jfed, ex)
        assert_close(T.tree_map(lambda x: x[i], theta), th)
    if stateful:
        theta_t = to_t(params)
        new = ts.client_state_update(extra, ctx_k, theta_t, theta, fed)
        for i in range(K):
            jnew = js.client_state_update(
                {name: client(cstate_k, i)}, jctx,
                jax.tree.map(jnp.asarray, params),
                jax.tree.map(jnp.asarray, T.tree_map(lambda x: x[i].numpy(),
                                                     theta)), jfed)
            assert_close(T.tree_map(lambda x: x[i], new), jnew)


@pytest.mark.parametrize("strategy", ["fedavg", "slowmo", "fedadc",
                                      "fedadc_double", "fedprox"])
def test_server_update(strategy):
    base = dict(strategy=strategy, eta=0.05, alpha=0.9, beta_global=0.7,
                beta_local=0.6)
    jfed, fed = JFedConfig(**base), FedConfig(**base)
    js, ts = JS.get_strategy(strategy), S.get_strategy(strategy)
    params, mean_delta = tree_np(1), tree_np(5)
    ss = server_state_np(strategy, 2)
    jt, jss = js.server_update(jax.tree.map(jnp.asarray, ss),
                               jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, mean_delta), jfed)
    tt, tss = ts.server_update(to_t(ss), to_t(params), to_t(mean_delta), fed)
    assert_close(tt, jt)
    assert_close(tss, jss)
    for leaf in T.leaves(tss):
        assert leaf.dtype == torch.float32


def test_server_update_scaffold_and_feddyn():
    fed, jfed = FedConfig(feddyn_alpha=0.05), JFedConfig(feddyn_alpha=0.05)
    p, a, b = tree_np(1), tree_np(2), tree_np(3)
    c = {"c": tree_np(4)}
    jt, jss = JS.Scaffold().server_update_scaffold(
        jax.tree.map(jnp.asarray, c), jax.tree.map(jnp.asarray, p),
        jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b), jfed, 0.3)
    tt, tss = S.Scaffold().server_update_scaffold(to_t(c), to_t(p), to_t(a),
                                                  to_t(b), fed, 0.3)
    assert_close(tt, jt)
    assert_close(tss, jss)
    h = {"h": tree_np(4)}
    jt, jss = JS.FedDyn().server_update_feddyn(
        jax.tree.map(jnp.asarray, h), jax.tree.map(jnp.asarray, p),
        jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, b), jfed)
    tt, tss = S.FedDyn().server_update_feddyn(to_t(h), to_t(p), to_t(a),
                                              to_t(b), fed)
    assert_close(tt, jt)
    assert_close(tss, jss)


@pytest.mark.parametrize("aggregator", ["uniform", "examples", "drag"])
@pytest.mark.parametrize("with_momentum", [False, True])
def test_aggregation(aggregator, with_momentum):
    deltas = tree_np(6, (K,))
    n_examples = np.array([30.0, 10.0, 60.0], np.float32)
    ref = tree_np(7) if with_momentum else None
    jw = JA.compute_weights(
        aggregator, jax.tree.map(jnp.asarray, deltas),
        n_examples=jnp.asarray(n_examples),
        ref=None if ref is None else jax.tree.map(jnp.asarray, ref), lam=4.0)
    tw = A.compute_weights(aggregator, to_t(deltas),
                           n_examples=torch.from_numpy(n_examples),
                           ref=None if ref is None else to_t(ref), lam=4.0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    jm = JA.weighted_mean(jax.tree.map(jnp.asarray, deltas), jw)
    tm = A.weighted_mean(to_t(deltas), tw)
    assert_close(tm, jm)
