"""The port's LM stack (configs, layers, GQA, Mamba2, the decoder stack, the
registry and the converter) held against the JAX package on the CPU.

Parameters come from the reference's own init, converted leaf for leaf
(``repro_torch.convert``); inputs are numpy-made.  Bars: 1e-5 of the
largest magnitude where the two compute the same ops in fp32 (layers,
attention, a Mamba2 block, the stack's logits: only the summation order of
matrix products and einsums differs); the routes that differ between the
packages in their own algorithm (the Pallas kernels in interpret mode
against the port's plain versions) at the kernels' bar, 2e-5.

The hybrid configs are ``reduced()`` zamba2 with an explicit block pattern
that holds ``SHARED_ATTN``: the reduced config keeps only two Mamba2
blocks and so no attention.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import SHAPES as JSHAPES
from repro.models import attention as jA
from repro.models import layers as jL
from repro.models import mamba2 as jM2
from repro.models import transformer as jT
from repro.models.registry import count_params as jcount_params
from repro.models.registry import get_model as jget_model
from repro_torch import convert
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.configs.base import MAMBA2, SHARED_ATTN
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import transformer as T
from repro_torch.models.registry import count_params, get_model

SUPPORTED = sorted(ARCHS)


def hybrid(pattern=(MAMBA2, MAMBA2, SHARED_ATTN, MAMBA2, SHARED_ATTN)):
    return replace(get_arch("zamba2-1.2b").reduced(), block_pattern=pattern)


def dense(**kw):
    """Reduced Qwen3 (qk-norm, GQA) with qkv bias, and the overrides."""
    return replace(get_arch("qwen3-4b").reduced(), qkv_bias=True,
                   n_kv_heads=2, **kw)


def windowed():
    """Layer 0 windowed (16), layer 1 global: two runs."""
    return dense(sliding_window=16, global_attn_every=2)


def jcfg(cfg):
    """The same configuration as the reference's dataclass."""
    from repro.configs import base as jbase
    kw = dataclasses.asdict(cfg)
    for name, cls in (("ssm", jbase.SSMConfig), ("moe", jbase.MoEConfig),
                      ("mla", jbase.MLAConfig)):
        if kw[name] is not None:
            kw[name] = cls(**kw[name])
    return jbase.ModelConfig(**kw)


def np_tree(t):
    return jax.tree.map(np.asarray, t)


def params_pair(cfg, seed=0):
    """(port params, reference params) from the reference's init."""
    jp = jax.jit(lambda k: jT.init(k, jcfg(cfg)))(jax.random.PRNGKey(seed))
    return convert.from_numpy(np_tree(jp), "cpu"), jp


def tokens(cfg, B, Lq, seed=1):
    t = np.random.RandomState(seed).randint(0, cfg.vocab_size, (B, Lq))
    return torch.from_numpy(t), jnp.asarray(t, jnp.int32)


def assert_rel(got, want, tol=1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------
def test_configs_are_copies_of_the_reference():
    assert sorted(ARCHS) == sorted(JARCHS)
    for arch, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(JARCHS[arch])
        assert dataclasses.asdict(cfg.reduced()) == \
            dataclasses.asdict(JARCHS[arch].reduced())
        assert cfg.blocks() == JARCHS[arch].blocks()
        assert cfg.supports_long_context == JARCHS[arch].supports_long_context
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", SUPPORTED)
def test_count_params_matches_reference(arch):
    """Full width, from shapes alone (the ``meta`` device)."""
    cfg = ARCHS[arch]
    assert count_params(cfg) == jcount_params(JARCHS[arch])
    assert cfg.param_count() == count_params(cfg)
    assert T.partition_runs(cfg) == jT.partition_runs(JARCHS[arch])


def test_zamba2_full_width_count():
    assert count_params(ARCHS["zamba2-1.2b"]) == 1_104_937_856


def test_port_init_has_the_reference_tree_and_distributions():
    cfg = hybrid()
    pt = T.init(0, cfg, device="cpu")
    jp = jax.eval_shape(lambda k: jT.init(k, jcfg(cfg)),
                        jax.random.PRNGKey(0))
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}

    def flat(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items()
                    for k2, v2 in flat(v, f"{pre}{k}/").items()}
        return {pre[:-1]: (tuple(t.shape), str(t.dtype).replace("torch.", ""))}
    assert flat(pt) == want
    mix = pt["runs"]["0"]["mix"]
    H = mix["A_log"].shape[-1]
    torch.testing.assert_close(mix["A_log"][1], torch.log(torch.arange(
        1, H + 1, dtype=torch.float32)))
    assert torch.equal(mix["D"], torch.ones_like(mix["D"]))
    assert not mix["dt_bias"].any()
    w = mix["in_proj"]["w"]
    bound = 1 / np.sqrt(cfg.d_model)
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    emb = pt["embed"]["emb"]
    assert abs(emb.std().item() - 0.02) < 1e-3


def test_convert_round_trips_a_hybrid_lm_tree():
    """Nested runs, stacked leaves, conv_w/A_log/D/dt_bias and the tied
    embedding come across leaf for leaf, and no LM leaf is permuted (a 4-d
    leaf named ``w`` in an LM tree included)."""
    _, jp = params_pair(hybrid())
    p = np_tree(jp)
    t = convert.from_numpy(p, "cpu")
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        b.numpy(), a), p, t)
    jax.tree.map(np.testing.assert_array_equal, convert.to_numpy(t), p)
    lm4d = {"runs": {"0": {"mix": {"in_proj": {
        "w": np.arange(120, dtype=np.float32).reshape(2, 3, 4, 5)}}}}}
    back = convert.from_numpy(lm4d, "cpu")["runs"]["0"]["mix"]["in_proj"]["w"]
    np.testing.assert_array_equal(back.numpy(),
                                  lm4d["runs"]["0"]["mix"]["in_proj"]["w"])


def test_convert_round_trips_every_arch_tree():
    """Each arch's reduced tree, the reference's key paths and shapes filled
    with seeded values, crosses to the port and back bit for bit, and the
    port's own init has the same paths, shapes and dtypes: no leaf is
    permuted (the stacked MoE experts are 4-d but named gate/up/down; the
    sLSTM's r, the mLSTM's conv_w, vis_proj, enc/dec)."""
    rng = np.random.RandomState(0)
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch].reduced()
        jmodel = jget_model(JARCHS[arch].reduced())
        shapes = jax.eval_shape(lambda k: jmodel.init(k, jcfg(cfg)),
                                jax.random.PRNGKey(0))
        p = jax.tree.map(lambda a: rng.randn(*a.shape).astype(a.dtype),
                         shapes)
        t = convert.from_numpy(p, "cpu")
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            b.numpy(), a), p, t)
        jax.tree.map(np.testing.assert_array_equal, convert.to_numpy(t), p)
        own = get_model(cfg).init(0, cfg, device="meta")
        jax.tree.map(lambda a, b: (a.shape, str(a.dtype)) == (
            b.shape, str(b.dtype).replace("torch.", "")) or pytest.fail(
                f"{arch}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}"),
            shapes, own)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layers_match_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    scale = rng.randn(16).astype(np.float32)
    assert_rel(L.rmsnorm({"scale": torch.from_numpy(scale)},
                         torch.from_numpy(x)),
               jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    pos = np.arange(7)[None, :] + np.array([[0], [40]])
    cos, sin = L.rope_freqs(16, 1e6, torch.from_numpy(pos))
    jcos, jsin = jL.rope_freqs(16, 1e6, jnp.asarray(pos))
    assert_rel(cos, jcos, 1e-6)
    assert_rel(L.apply_rope(torch.from_numpy(x), cos, sin),
               jL.apply_rope(jnp.asarray(x), jcos, jsin))
    jp = np_tree(jax.jit(lambda k: jL.mlp_init(k, 16, 24))(
        jax.random.PRNGKey(1)))
    h = x.reshape(14, 4, 16)
    assert_rel(L.mlp(convert.from_numpy(jp, "cpu"), torch.from_numpy(h)),
               jL.mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(h)))
    emb = rng.randn(11, 5).astype(np.float32)
    ids = np.array([[0, 3, 10], [10, 1, 1]])
    np.testing.assert_array_equal(
        L.embed({"emb": torch.from_numpy(emb)}, torch.from_numpy(ids)).numpy(),
        np.asarray(jL.embed({"emb": jnp.asarray(emb)}, jnp.asarray(ids))))


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cfg_fn,layer_idx", [(dense, 0), (windowed, 0),
                                              (windowed, 1)])
def test_gqa_forward_matches_reference(cfg_fn, layer_idx):
    """qk-norm, qkv bias and GQA; the windowed layer takes the masked
    route, the global one the causal route."""
    cfg = cfg_fn()
    jp = np_tree(jax.jit(lambda k: jA.gqa_init(k, jcfg(cfg)))(
        jax.random.PRNGKey(2)))
    x = np.random.RandomState(3).randn(2, 40, cfg.d_model).astype(np.float32)
    want = jA.gqa_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                          jcfg(cfg), layer_idx)
    for use_pallas in (False, True):
        got = A.gqa_forward(convert.from_numpy(jp, "cpu"), torch.from_numpy(x),
                            cfg, layer_idx, use_pallas=use_pallas)
        assert_rel(got, want)


@pytest.mark.parametrize("window", [0, 512])
def test_sdpa_auto_chunked_route(window):
    """Lq ≥ 8192: the q blocks of 1024 (and the window's key band)."""
    rng = np.random.RandomState(window)
    q, k, v = (rng.randn(1, 8192, h, 8).astype(np.float32)
               for h in (2, 1, 1))
    got = A.sdpa_auto(*map(torch.from_numpy, (q, k, v)), causal=True,
                      window=window)
    want = jA.sdpa_auto(*map(jnp.asarray, (q, k, v)), causal=True,
                        window=window)
    assert_rel(got, want)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba_block():
    cfg = hybrid()
    jp = np_tree(jax.jit(lambda k: jM2.mamba2_init(k, jcfg(cfg)))(
        jax.random.PRNGKey(4)))
    x = 0.5 * np.random.RandomState(5).randn(2, 64, cfg.d_model).astype(
        np.float32)
    return cfg, jp, x


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mamba2_forward_matches_reference(mamba_block, use_pallas):
    cfg, jp, x = mamba_block
    got = M2.mamba2_forward(convert.from_numpy(jp, "cpu"), torch.from_numpy(x),
                            cfg, use_pallas)
    want = jM2.mamba2_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                              jcfg(cfg), use_pallas)
    assert_rel(got, want, 2e-5)


def test_mamba2_decode_matches_reference(mamba_block):
    cfg, jp, x = mamba_block
    p, jpp = convert.from_numpy(jp, "cpu"), jax.tree.map(jnp.asarray, jp)
    cache = M2.mamba2_init_cache(cfg, 2, torch.float32)
    jcache = jM2.mamba2_init_cache(jcfg(cfg), 2, jnp.float32)
    for t in range(6):
        y, cache = M2.mamba2_decode(p, torch.from_numpy(x[:, t:t + 1]), cache,
                                    cfg)
        jy, jcache = jM2.mamba2_decode(jpp, jnp.asarray(x[:, t:t + 1]),
                                       jcache, jcfg(cfg))
        assert_rel(y, jy)
    for k in ("h", "conv"):
        assert_rel(cache[k], jcache[k])


# ---------------------------------------------------------------------------
# the decoder stack
# ---------------------------------------------------------------------------
STACKS = {"hybrid": hybrid, "dense": dense, "windowed": windowed}


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    cfg = STACKS[request.param]()
    p, jp = params_pair(cfg)
    return cfg, p, jp


@pytest.mark.parametrize("use_pallas", [False, True])
def test_forward_matches_reference(stack, use_pallas):
    cfg, p, jp = stack
    t, jt = tokens(cfg, 2, 64)
    got, aux = T.forward(p, {"tokens": t}, cfg, use_pallas)
    want, _ = jT.forward(jp, {"tokens": jt}, jcfg(cfg), use_pallas)
    assert got.shape == want.shape and float(aux) == 0.0
    assert_rel(got, want, 2e-5 if use_pallas else 1e-5)
    last, _ = T.forward(p, {"tokens": t}, cfg, use_pallas,
                        logits_slice="last")
    assert tuple(last.shape) == (2, 1, cfg.vocab_size)
    assert_rel(last[:, 0], got[:, -1].numpy())


def test_loss_fn_matches_reference(stack):
    cfg, p, jp = stack
    t, jt = tokens(cfg, 2, 64)
    labels = t.clone()
    labels[0, 10:20] = -1
    loss, parts = T.loss_fn(p, {"tokens": t, "labels": labels}, cfg)
    jloss, jparts = jT.loss_fn(jp, {"tokens": jt, "labels": jnp.asarray(
        labels.numpy(), jnp.int32)}, jcfg(cfg))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-6)
    np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]),
                               rtol=1e-6)


def test_init_cache_matches_reference(stack):
    cfg = stack[0]
    got = T.init_cache(cfg, 3, 40, torch.float32, device="cpu")
    want = jT.init_cache(jcfg(cfg), 3, 40, jnp.float32)
    assert sorted(got) == sorted(want)
    for ri in want:
        assert sorted(got[ri]) == sorted(want[ri])
        for k in want[ri]:
            np.testing.assert_array_equal(got[ri][k].numpy(),
                                          np.asarray(want[ri][k]))


def test_decode_step_matches_reference(stack):
    """A scalar position for the prompt, then per-slot positions with an
    active mask: the inactive slot's cache stays bit for bit."""
    cfg, p, jp = stack
    B, P = 3, 12
    t, jt = tokens(cfg, B, P + 4, seed=7)
    cache = T.init_cache(cfg, B, 32, torch.float32, device="cpu")
    jcache = jT.init_cache(jcfg(cfg), B, 32, jnp.float32)
    jdecode = jax.jit(lambda c, tok, pos, active: jT.decode_step(
        jp, c, tok, pos, jcfg(cfg), active=active))
    for i in range(P):
        lg, cache = T.decode_step(p, cache, t[:, i:i + 1], i, cfg)
        jlg, jcache = jdecode(jcache, jt[:, i:i + 1], jnp.int32(i), None)
        assert_rel(lg, jlg)
    pos = np.array([P, P + 2, P])
    active = np.array([True, True, False])
    for step in range(3):
        before = {ri: {k: v.clone() for k, v in run.items()}
                  for ri, run in cache.items()}
        lg, cache = T.decode_step(p, cache, t[:, P + step:P + step + 1],
                                  torch.from_numpy(pos + step), cfg,
                                  active=torch.from_numpy(active))
        jlg, jcache = jdecode(jcache, jt[:, P + step:P + step + 1],
                              jnp.asarray(pos + step, jnp.int32),
                              jnp.asarray(active))
        assert_rel(lg, jlg)
        for ri, run in cache.items():
            for k, leaf in run.items():
                assert torch.equal(leaf[:, 2], before[ri][k][:, 2])
                assert_rel(leaf, jcache[ri][k])


def test_decode_matches_forward(stack):
    """The cache path and the full forward agree on the prompt's logits."""
    cfg, p, _ = stack
    t, _ = tokens(cfg, 2, 20, seed=9)
    full, _ = T.forward(p, {"tokens": t}, cfg)
    cache = T.init_cache(cfg, 2, 20, torch.float32, device="cpu")
    for i in range(20):
        lg, cache = T.decode_step(p, cache, t[:, i:i + 1], i, cfg)
        assert_rel(lg, full[:, i].numpy(), 1e-5)
