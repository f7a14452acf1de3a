"""The rest of the port's LM stack held against the JAX package on the CPU:
MoE (Llama-4 Scout, DeepSeek-V3), MLA and its absorbed decode (DeepSeek-V3),
the xLSTM (mLSTM and sLSTM), the encoder-decoder (Whisper), the VLM patch
prefix (InternVL2), ``optim/`` and the deprecated ``compress_delta`` shim.

Each arch runs at its ``reduced()`` config in fp32, with parameters from
the reference's own init converted leaf for leaf and numpy-made inputs.
The reduced xLSTM keeps two mLSTM blocks and no sLSTM, so its config here
is ``(MLSTM, SLSTM)``; the reduced Llama-4 Scout has two layers, both
windowed (128) at this length, so its kernel-route and decode checks use
four layers with a window of 16: layers 0-2 windowed past their window at
L 64, layer 3 global.

Bars (``test_torch_lm.py``'s): 1e-5 of max |logit| where both packages
compute the same fp32 ops; 2e-5 for the kernel route against the
reference's Pallas kernel in interpret mode; 1e-6 relative for losses;
the reference's own 2e-2 for decode against the forward.

Router ties: ``torch.topk`` gives no order for equal probabilities, where
``lax.top_k`` takes the lower index.  Every routing call of this module
is checked for a tie among a token's top k + 1 probabilities, and none
has one.
"""
import warnings
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _fixtures import one_torch_thread  # noqa: F401  (autouse)
from test_torch_lm import assert_rel, jcfg, np_tree

from repro.core import strategies as JS
from repro.models import encdec as jE
from repro.models import moe as jMOE
from repro.models import registry as jR
from repro.models.transformer import VIS_EMBED_DIM as JVIS
from repro.optim import optimizers as jO
from repro.optim import schedules as jSch
from repro_torch import convert, serve_demo
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import MLSTM, SLSTM, FedConfig
from repro_torch.core import strategies as S
from repro_torch.federated import compression as C
from repro_torch.federated import transport as TR
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.registry import count_params, get_model
from repro_torch.models.transformer import VIS_EMBED_DIM
from repro_torch.optim import optimizers as O
from repro_torch.optim import schedules as Sch
from repro_torch.serving import CacheManager

NEW = ["deepseek-v3-671b", "llama4-scout-17b-a16e", "xlstm-350m",
       "whisper-small", "internvl2-26b"]
SCOUT4 = "llama4-scout-17b-a16e/4"


def config(name):
    if name == SCOUT4:
        return replace(get_arch("llama4-scout-17b-a16e").reduced(),
                       n_layers=4, sliding_window=16)
    cfg = get_arch(name).reduced()
    if name == "xlstm-350m":
        cfg = replace(cfg, block_pattern=(MLSTM, SLSTM))
    return cfg


def dropless(cfg):
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0)) \
        if cfg.moe is not None else cfg


@pytest.fixture(autouse=True)
def no_router_ties(monkeypatch):
    """Every routing call: a token's top k + 1 probabilities are distinct."""
    route = MOE.route

    def checked(p, xt, cfg):
        probs = torch.softmax(L.linear(p["router"], xt.float()), -1)
        k1 = min(cfg.moe.top_k + 1, cfg.moe.n_experts)
        top = probs.topk(k1, dim=-1).values
        assert (top[:, :-1] > top[:, 1:]).all(), "a router tie"
        return route(p, xt, cfg)
    monkeypatch.setattr(MOE, "route", checked)


_PAIRS = {}


def pair(name):
    """(cfg, port params, reference params), each made once."""
    if name not in _PAIRS:
        cfg = config(name)
        jp = jax.jit(lambda k: jR.get_model(jcfg(cfg)).init(k, jcfg(cfg)))(
            jax.random.PRNGKey(0))
        _PAIRS[name] = cfg, convert.from_numpy(np_tree(jp), "cpu"), jp
    return _PAIRS[name]


def reference_decode(name):
    """The reference's decode_step for ``pair(name)``, jitted once."""
    cfg, _, jp = pair(name)
    key = name + "/decode"
    if key not in _PAIRS:
        jmodel = jR.get_model(jcfg(cfg))
        _PAIRS[key] = jax.jit(lambda c, tok, pos, active: jmodel.decode_step(
            jp, c, tok, pos, jcfg(cfg), active=active))
    return _PAIRS[key]


def batch_pair(cfg, B=2, Lq=24, seed=1):
    """Tokens, labels (some masked) and, where the arch takes them, seeded
    frames or patch embeddings -> (port batch, reference batch)."""
    rng = np.random.RandomState(seed)
    t = rng.randint(0, cfg.vocab_size, (B, Lq))
    labels = t.copy()
    labels[0, 3:7] = -1
    b = {"tokens": t, "labels": labels}
    if cfg.is_encoder_decoder:
        b["frames"] = rng.randn(B, 16, cfg.d_model).astype(np.float32)
    if cfg.n_patch_tokens > 0:
        b["patch_embeds"] = rng.randn(B, cfg.n_patch_tokens,
                                      VIS_EMBED_DIM).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else None)
          for k, v in b.items()}
    return {k: torch.from_numpy(v) for k, v in b.items()}, jb


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_layernorm_and_gelu_mlp_match_reference():
    """The GELU is the tanh form, jax.nn.gelu's default (F.gelu's is the
    erf form, which misses this bar)."""
    from repro.models import layers as jL
    rng = np.random.RandomState(0)
    x = (3 * rng.randn(2, 7, 16)).astype(np.float32)
    ln = {"scale": rng.randn(16).astype(np.float32),
          "bias": rng.randn(16).astype(np.float32)}
    assert_rel(L.layernorm(convert.from_numpy(ln, "cpu"), torch.from_numpy(x)),
               jL.layernorm(jax.tree.map(jnp.asarray, ln), jnp.asarray(x)))
    jp = np_tree(jax.jit(lambda k: jL.gelu_mlp_init(k, 16, 24))(
        jax.random.PRNGKey(1)))
    jp["fc1"]["b"] = rng.randn(24).astype(np.float32)
    assert_rel(L.gelu_mlp(convert.from_numpy(jp, "cpu"), torch.from_numpy(x)),
               jL.gelu_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x)))


# ---------------------------------------------------------------------------
# forward, loss, the kernel route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", NEW)
def test_forward_and_loss_match_reference(name):
    cfg, p, jp = pair(name)
    model, jmodel = get_model(cfg), jR.get_model(jcfg(cfg))
    b, jb = batch_pair(cfg, Lq=32 if cfg.n_patch_tokens else 24)
    got, aux = model.forward(p, b, cfg)
    (want, jaux), (jloss, jparts) = jax.jit(lambda q, x: (
        jmodel.forward(q, x, jcfg(cfg)), jmodel.loss_fn(q, x, jcfg(cfg))))(
            jp, jb)
    assert got.shape == want.shape
    assert_rel(got, want)
    assert rel(aux, jaux) <= 1e-6 and (float(jaux) > 0) == (cfg.moe
                                                            is not None)
    loss, parts = model.loss_fn(p, b, cfg)
    assert rel(loss, jloss) <= 1e-6 and rel(parts["ce"], jparts["ce"]) <= 1e-6
    if cfg.n_patch_tokens:
        assert VIS_EMBED_DIM == JVIS
        assert got.shape[1] == cfg.n_patch_tokens + b["tokens"].shape[1]


@pytest.mark.parametrize("name", ["internvl2-26b", SCOUT4])
def test_kernel_route_matches_reference(name):
    """use_pallas=True against the reference's Pallas route in interpret
    mode: the VLM prefix and the MoE blocks' GQA attention reach flash."""
    cfg, p, jp = pair(name)
    b, jb = batch_pair(cfg, Lq=64 - cfg.n_patch_tokens)
    got, aux = get_model(cfg).forward(p, b, cfg, True)
    want, jaux = jR.get_model(jcfg(cfg)).forward(jp, jb, jcfg(cfg), True)
    assert_rel(got, want, 2e-5)
    assert rel(aux, jaux) <= 1e-6


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "xlstm-350m",
                                  "whisper-small", SCOUT4])
def test_decode_matches_reference(name):
    """Step for step against the reference's decode_step: MLA's absorbed
    decode, the xLSTM states, Whisper after prefill_cross, and the
    four-layer Scout's ring caches (20 steps through a 16-slot ring; the
    rest 12 steps); then, for the decoder-only archs, per-slot positions
    under an active mask."""
    cfg, p, jp = pair(name)
    model, jmodel = get_model(cfg), jR.get_model(jcfg(cfg))
    B, steps = 3, 20 if name == SCOUT4 else 12
    b, jb = batch_pair(cfg, B, steps + 2, seed=5)
    cache = model.init_cache(cfg, B, 32, torch.float32, device="cpu")
    jcache = jmodel.init_cache(jcfg(cfg), B, 32, jnp.float32)
    if cfg.is_encoder_decoder:
        cache = E.prefill_cross(p, E.encode(p, b["frames"], cfg), cfg, cache)
        jcache = jE.prefill_cross(jp, jE.encode(jp, jb["frames"], jcfg(cfg)),
                                  jcfg(cfg), jcache)
    jdecode = reference_decode(name)
    toks, jtoks = b["tokens"], jb["tokens"]
    for i in range(steps):
        lg, cache = model.decode_step(p, cache, toks[:, i:i + 1], i, cfg)
        jlg, jcache = jdecode(jcache, jtoks[:, i:i + 1], jnp.int32(i), None)
        assert_rel(lg, jlg)
    jax.tree.map(lambda got, want: assert_rel(got.float(), want),
                 cache, jcache)
    if cfg.is_encoder_decoder:
        with pytest.raises(NotImplementedError, match="batch-shared kpos"):
            model.decode_step(p, cache, toks[:, :1], 0, cfg,
                              active=torch.ones(B, dtype=torch.bool))
        return
    pos = np.array([steps, steps + 1, steps])
    active = np.array([True, True, False])
    lg, new = model.decode_step(p, cache, toks[:, steps:steps + 1],
                                torch.from_numpy(pos), cfg,
                                active=torch.from_numpy(active))
    jlg, _ = jdecode(jcache, jtoks[:, steps:steps + 1],
                     jnp.asarray(pos, jnp.int32), jnp.asarray(active))
    assert_rel(lg, jlg)
    for ri, run in new.items():
        for k, leaf in run.items():
            assert torch.equal(leaf[:, 2], cache[ri][k][:, 2])


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "llama4-scout-17b-a16e",
                                  "xlstm-350m", "whisper-small",
                                  "internvl2-26b", SCOUT4])
def test_decode_matches_own_forward(name):
    """The port's decode against its own forward at the reference's 2e-2
    bar (``tests/test_archs_smoke.py:109-141``), the MoE at capacity 8.0
    as there (dropless at 4 experts).  The xLSTM is its plain
    ``reduced()`` (two mLSTM blocks): the sLSTM's norm spans the whole
    sequence in the forward (see the next test)."""
    cfg = dropless(get_arch(name).reduced() if name != SCOUT4
                   else config(name))
    model = get_model(cfg)
    p = model.init(0, cfg, device="cpu")
    # Whisper as the reference's test_encdec_decode: 12 tokens, 16 frames
    Lq = 12 if cfg.is_encoder_decoder else 24
    b, _ = batch_pair(cfg, 1, Lq, seed=9)
    if cfg.n_patch_tokens:
        del b["patch_embeds"]
    full, _ = model.forward(p, b, cfg)
    cache = model.init_cache(cfg, 1, 16 if cfg.is_encoder_decoder else Lq,
                             torch.float32, device="cpu")
    if cfg.is_encoder_decoder:
        cache = E.prefill_cross(p, E.encode(p, b["frames"], cfg), cfg, cache)
    for t in range(Lq):
        lg, cache = model.decode_step(p, cache, b["tokens"][:, t:t + 1], t,
                                      cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   atol=2e-2, rtol=2e-2)


def test_slstm_decode_is_not_the_forward_prefix():
    """The reference's sLSTM forward normalises over every position of the
    sequence (its groupnorm's axes include L), a decode step over its own:
    so decode departs from the forward, in the reference as in the port,
    by the same amount."""
    cfg, p, jp = pair("xlstm-350m")
    model, jmodel = get_model(cfg), jR.get_model(jcfg(cfg))
    b, jb = batch_pair(cfg, 3, 12, seed=9)
    full, _ = model.forward(p, b, cfg)
    jfull, _ = jax.jit(lambda q, x: jmodel.forward(q, x, jcfg(cfg)))(jp, jb)
    cache = model.init_cache(cfg, 3, 32, torch.float32, device="cpu")
    jcache = jmodel.init_cache(jcfg(cfg), 3, 32, jnp.float32)
    jdecode = reference_decode("xlstm-350m")
    gap, jgap = [], []
    for t in range(12):
        lg, cache = model.decode_step(p, cache, b["tokens"][:, t:t + 1], t,
                                      cfg)
        jlg, jcache = jdecode(jcache, jb["tokens"][:, t:t + 1], jnp.int32(t),
                              None)
        gap.append((lg - full[:, t]).abs().max().item())
        jgap.append(float(jnp.abs(jlg - jfull[:, t]).max()))
    assert max(jgap) > 2e-2
    np.testing.assert_allclose(gap, jgap, rtol=1e-3, atol=1e-5)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def test_moe_with_drops_matches_reference(monkeypatch):
    """A capacity that overflows: the same assignments kept, in the same
    slots (the dispatch buffer bit for bit), and the same output; the
    reference's buffer is read where it pins it to the mesh."""
    cfg, _, jparams = pair("deepseek-v3-671b")
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=0.5))
    # the MoE block of the reduced model's layer 1 (layer 0 is dense)
    jp = jax.tree.map(lambda a: np.asarray(a[0]), jparams["runs"]["1"]["moe"])
    p = convert.from_numpy(jp, "cpu")
    x = np.random.RandomState(4).randn(2, 20, cfg.d_model).astype(np.float32)
    seen = []

    def record(a, *spec):
        seen.append(np.asarray(a))
        return a
    monkeypatch.setattr(jMOE, "_constrain", record)
    want, jaux = jMOE.moe_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                                jcfg(cfg))
    jbuf = seen[1]                                   # (E, cap, d)
    got, aux = MOE.moe_apply(p, torch.from_numpy(x), cfg)
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    flat_e, _, pos, keep, _ = MOE.route(p, xt, cfg)
    cap = MOE.capacity(cfg, xt.shape[0])
    assert jbuf.shape[1] == cap and not keep.all()
    buf = torch.zeros((cfg.moe.n_experts, cap + 1, cfg.d_model))
    rows = torch.arange(flat_e.numel()) // cfg.moe.top_k
    buf[flat_e[keep], pos[keep]] = xt[rows[keep]]
    np.testing.assert_array_equal(buf[:, :cap].numpy(), jbuf)
    assert_rel(got, want)
    assert rel(aux, jaux) <= 1e-6


@pytest.mark.parametrize("arch", ["deepseek-v3-671b",
                                  "llama4-scout-17b-a16e"])
def test_count_params_active_only_matches_reference(arch):
    from repro.configs import ARCHS as JARCHS
    cfg = ARCHS[arch]
    active = count_params(cfg, active_only=True)
    assert active == jR.count_params(JARCHS[arch], active_only=True)
    assert active < count_params(cfg)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["deepseek-v3-671b", "xlstm-350m"])
def test_cache_manager_resets_mla_and_xlstm_slots(name):
    """Admission writes a fresh slot (kpos -1, the mLSTM's m -1e30, zeros)
    over what the slot's last request left; MLA pays KV pages, the xLSTM
    one state page."""
    cfg = config(name)
    mgr = CacheManager(cfg, 2, 64, page_size=16, device="cpu")
    fresh = get_model(cfg).init_cache(cfg, 1, 64, torch.float32,
                                      device="cpu")
    for run in mgr.cache.values():
        for leaf in run.values():
            leaf.fill_(7)
    slot = mgr.admit(40)
    for ri, run in mgr.cache.items():
        for k, leaf in run.items():
            assert torch.equal(leaf[:, slot], fresh[ri][k][:, 0])
            assert (leaf[:, 1 - slot] == 7).all()
    assert mgr.pages_for(40) == (3 if cfg.mla is not None else 1)


@pytest.mark.parametrize("name", NEW)
def test_serve_demo_serves_every_new_arch(name, capsys):
    gen = serve_demo.main(
        ["--arch", name, "--device", "cpu", "--batch", "2",
         "--prompt-len", "3", "--gen", "2"])
    assert tuple(gen.shape) == (2, 3)
    if name == "whisper-small":
        with pytest.raises(ValueError, match="enc-dec"):
            serve_demo.main(
                ["--arch", name, "--device", "cpu", "--engine"])


# ---------------------------------------------------------------------------
# optim/
# ---------------------------------------------------------------------------
def _opt_trees(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(6, 5).astype(np.float32),
            "b": {"c": rng.randn(7).astype(np.float32)}}


@pytest.mark.parametrize("opt", ["sgd", "momentum", "nesterov", "adamw"])
def test_optimizers_match_reference(opt):
    kw = dict(weight_decay=0.01)
    p = convert.from_numpy(_opt_trees(0), "cpu")
    jp = jax.tree.map(jnp.asarray, _opt_trees(0))
    state = jstate = None
    if opt in ("momentum", "nesterov"):
        state, jstate = O.momentum_init(p), jO.momentum_init(jp)
        kw["nesterov"] = opt == "nesterov"
    elif opt == "adamw":
        state, jstate = O.adamw_init(p), jO.adamw_init(jp)
    for step in range(3):
        g = _opt_trees(10 + step)
        tg, jg = convert.from_numpy(g, "cpu"), jax.tree.map(jnp.asarray, g)
        if opt == "sgd":
            p, jp = O.sgd_update(p, tg, 0.1, **kw), \
                jO.sgd_update(jp, jg, 0.1, **kw)
        elif opt == "adamw":
            p, state = O.adamw_update(p, tg, state, 0.01, **kw)
            jp, jstate = jO.adamw_update(jp, jg, jstate, 0.01, **kw)
            assert int(state["t"]) == int(jstate["t"]) == step + 1
        else:
            p, state = O.momentum_update(p, tg, state, 0.1, beta=0.8, **kw)
            jp, jstate = jO.momentum_update(jp, jg, jstate, 0.1, beta=0.8,
                                            **kw)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, b, rtol=0, atol=1e-6), convert.to_numpy(p), np_tree(jp))


def test_schedules_match_reference():
    grid = [0, 1, 3, 5, 9, 10, 17, 50, 99, 100, 140]
    pairs = [(Sch.constant(0.3), jSch.constant(0.3)),
             (Sch.cosine_decay(0.3, 100), jSch.cosine_decay(0.3, 100)),
             (Sch.cosine_decay(0.3, 100, 0.01),
              jSch.cosine_decay(0.3, 100, 0.01)),
             (Sch.warmup_cosine(0.3, 10, 100), jSch.warmup_cosine(0.3, 10,
                                                                   100)),
             (Sch.warmup_cosine(0.3, 10, 100, 0.05),
              jSch.warmup_cosine(0.3, 10, 100, 0.05))]
    for f, jf in pairs:
        for t in grid:
            got = f(t)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(jf(t)), rtol=0,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# the deprecated compress_delta shim
# ---------------------------------------------------------------------------
def _fed(**kw):
    base = dict(local_steps=4, clients_per_round=3, n_clients=10, eta=0.03)
    base.update(kw)
    return FedConfig(**base)


def _draws():
    return C.UniformDraws(C.GeneratorUniforms(0, "cpu"), ("uplink",), "cpu")


@pytest.mark.parametrize("wire", [dict(compressor="topk", topk_frac=0.1),
                                  dict(compressor="qsgd", qsgd_bits=4)])
def test_compress_delta_warns_once_and_delegates(wire):
    """Mirrors ``tests/test_transport.py:1421-1440``: one warning, then
    ``Transport.uplink``'s result bit for bit with the same draws."""
    fed = _fed(**wire)
    s = S.get_strategy("fedadc")
    rng = np.random.RandomState(0)
    delta = {"w": torch.from_numpy(rng.randn(3, 64, 32).astype(np.float32)),
             "b": torch.from_numpy(rng.randn(3, 17).astype(np.float32))}
    ef = {k: torch.zeros_like(v) for k, v in delta.items()}
    S._DEPRECATION_WARNED.discard("strategy.compress_delta")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        q1, e1 = s.compress_delta(delta, ef, _draws(), fed)
        q2, e2 = s.compress_delta(delta, ef, _draws(), fed)
    deps = [x for x in w if issubclass(x.category, DeprecationWarning)]
    assert len(deps) == 1 and "compress_delta" in str(deps[0].message)
    q_ref, e_ref = TR.Transport(fed).uplink(delta, ef, _draws())
    for a, b in ((q1, q_ref), (e1, e_ref), (q2, q1), (e2, e1)):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert not torch.equal(q1["w"], delta["w"])
    # the reference's hook is the same shim
    assert JS.FedAvg.compress_delta.__doc__.lstrip().startswith("DEPRECATED")


def test_shim_transport_cache_is_keyed_on_the_uplink():
    """Mirrors ``tests/test_transport.py:813-842``."""
    import dataclasses
    a = TR.shim_transport(_fed(compressor="topk", topk_frac=0.1, eta=0.01))
    assert TR.shim_transport(_fed(compressor="topk", topk_frac=0.1,
                                  eta=0.9)) is a
    b = TR.shim_transport(_fed(compressor="qsgd", qsgd_bits=4))
    assert b is not a and (a.up.name, b.up.name) == ("topk", "qsgd")
    c = TR.shim_transport(_fed(compressor="topk", topk_frac=0.2))
    assert c is not a and a.up._comp.frac != c.up._comp.frac

    @dataclasses.dataclass
    class MutableFed:
        compressor: str = "topk"
        topk_frac: float = 0.1
        qsgd_bits: int = 8
        error_feedback: bool = True
        sparse_uplink: bool = False
        use_pallas: bool = False

    with pytest.raises(TypeError, match="frozen"):
        TR.shim_transport(MutableFed())
