"""The port's pod engine (``repro_torch.launch.train``) held against the
reference's on the CPU: one engine, every strategy it supports, the LM
archs.

Both packages start from the reference's init, converted leaf for leaf,
and train on the same numpy tokens (``np.random.RandomState``), with one
padding label (-100) in every client's batch.  Shape: CP 1 pod, CS 2
clients, H 2 steps of b 2 x L 32, two rounds (the second one with a
non-zero momentum, so FedADC's m̄ reaches the local steps).  Each
reference step is jitted once per configuration and shared by the tests
of this module (``reference``).

Bars.  A parameter near 1 (a norm's scale) is rounded once more at each
step than it moves: one fp32 ulp of it is ~1e-5 of a round's largest
|Δθ| here.  So the parameters agree within 1e-5 of max |Δθ| beyond (H +
1) ulps of θ per round, and the momentum (Δ̄/η) within 1e-5 of max |m|
beyond the same ulps over η; measured excess ~1e-6.  The mixed round
(bf16 local steps) agrees within 2e-2 of max |Δθ| beyond (H + 1) bf16 ulps
of θ (measured excess 9.5e-3 after one round).  Losses agree within 1e-6
relative (fp32) and 1e-3 (mixed).
"""
from dataclasses import asdict, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _fixtures import one_torch_thread  # noqa: F401  (autouse)
from test_torch_lm import jcfg, np_tree

from repro.configs.base import FedConfig as JFed
from repro.configs.base import RunConfig as JRun
from repro.launch import train as JT
from repro_torch import convert
from repro_torch.benchmarks import lm_round
from repro_torch.configs import get_arch
from repro_torch.configs.base import (MAMBA2, SHARED_ATTN, FedConfig,
                                      RunConfig)
from repro_torch.launch import train as PT
from repro_torch.models.transformer import VIS_EMBED_DIM

FP32 = RunConfig(remat="none", compute_dtype="float32")
MIXED = RunConfig(remat="none")
ARCHS = ["qwen3-4b", "zamba2-1.2b", "whisper-small", "internvl2-26b",
         "deepseek-v3-671b"]


def fed_config(**kw):
    base = dict(strategy="fedadc", local_steps=2, clients_per_round=2,
                eta=0.05)
    base.update(kw)
    return FedConfig(**base)


def make_batches(cfg, rounds=2, CP=1, CS=2, H=2, b=2, L=32, seed=1):
    """Numpy batches, one a round: tokens and next-token labels with one
    padding label per client, and seeded frames or patch embeddings where
    the arch takes them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(rounds):
        tok = rng.randint(0, cfg.vocab_size, (CP, CS, H, b, L + 1))
        batch = {"tokens": tok[..., :-1].astype(np.int32),
                 "labels": tok[..., 1:].astype(np.int32)}
        batch["labels"][:, :, 0, 0, 3] = -100
        if cfg.is_encoder_decoder:
            batch["frames"] = rng.randn(CP, CS, H, b, 16, cfg.d_model
                                        ).astype(np.float32)
        if cfg.n_patch_tokens > 0:
            batch["patch_embeds"] = rng.randn(
                CP, CS, H, b, cfg.n_patch_tokens, VIS_EMBED_DIM
            ).astype(np.float32)
        out.append(batch)
    return out


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


_STEPS = {}


def reference(cfg, fed, run, batches, telemetry=None, seed=0):
    """The reference's init and rounds -> [state after each round (numpy;
    the first the init)], [aux of each round].  The jitted step is made
    once per (cfg, fed, run, telemetry on)."""
    key = (repr(cfg), repr(fed), repr(run), telemetry is not None)
    if key not in _STEPS:
        _STEPS[key] = (
            JT.init_state(jax.random.PRNGKey(seed), jcfg(cfg),
                          JFed(**asdict(fed)), JRun(**asdict(run))),
            jax.jit(JT.make_train_step(jcfg(cfg), JFed(**asdict(fed)),
                                       JRun(**asdict(run)),
                                       telemetry=telemetry)))
    state, step = _STEPS[key]
    states, auxes = [np_tree(state)], []
    for b in batches:
        state, aux = step(state, jax_batch(b))
        states.append(np_tree(state))
        auxes.append(np_tree(aux))
    return states, auxes


def port(cfg, fed, run, jstate0, batches, telemetry=None, uniforms=None):
    """The port from the reference's initial parameters -> [state after
    each round], [aux of each round]."""
    state = PT.init_state(0, cfg, fed, run, device="cpu",
                          params=convert.from_numpy(jstate0["params"], "cpu"))
    step = PT.make_train_step(cfg, fed, run, telemetry=telemetry,
                              uniforms=uniforms)
    states, auxes = [state], []
    for b in batches:
        state, aux = step(state, torch_batch(b))
        states.append(state)
        auxes.append(aux)
    return states, auxes


def bf16_spacing(x):
    """One bf16 ulp of |x| (elementwise, normal numbers)."""
    x = np.maximum(np.abs(np.asarray(x, np.float32)), 1e-30)
    return np.exp2(np.floor(np.log2(x)) - 7)


def assert_update(got, want, before, rounds, H, tol=1e-5, over=1.0,
                  spacing=np.spacing, base=None, flips=0):
    """Every leaf of ``got`` (port tensors) within ``tol`` of max |want −
    base| (``base`` None: max |want|) beyond ``rounds·(H + 1)`` ulps of
    ``before`` (the parameters the rounds started from) divided by
    ``over``; except, where ``flips`` is given, that many elements of a
    leaf, each within a tenth of the scale (a stochastic rounding flipped
    at its boundary moves one entry of one client by one level)."""
    g = jax.tree.leaves(convert.to_numpy(got))
    w = jax.tree.leaves(want)
    p0 = jax.tree.leaves(before)
    b0 = p0 if base is None else jax.tree.leaves(base)
    assert len(g) == len(w) == len(p0)
    scale = max(float(np.abs(a - (0 if base is None else c)).max())
                for a, c in zip(w, b0))
    if scale == 0:      # nothing moved: nothing may
        assert all(np.array_equal(a, b) for a, b in zip(g, w))
        return
    slack = [rounds * (H + 1) * spacing(np.abs(p).astype(np.float32)) / over
             for p in p0]
    for a, b, s in zip(g, w, slack):
        excess = np.sort(np.maximum(np.abs(a - b) - s, 0).reshape(-1))
        assert excess[-1 - flips] <= tol * scale, \
            (excess[-1 - flips] / scale, tol)
        if flips:
            assert excess[-1] <= 0.1 * scale, (excess[-1] / scale, flips)


def assert_rounds(cfg, fed, run=FP32, rounds=2, tol=1e-5, loss_tol=1e-6,
                  spacing=np.spacing):
    batches = make_batches(cfg, rounds)
    jstates, jaux = reference(cfg, fed, run, batches)
    pstates, paux = port(cfg, fed, run, jstates[0], batches)
    H = fed.local_steps
    p0 = jstates[0]["params"]
    assert_update(pstates[-1]["params"], jstates[-1]["params"], p0, rounds,
                  H, tol, spacing=spacing, base=p0)
    if "m" in jstates[-1]["server"]:
        assert_update(pstates[-1]["server"]["m"], jstates[-1]["server"]["m"],
                      p0, rounds, H, tol, over=fed.eta, spacing=spacing)
    for a, b in zip(paux, jaux):
        assert abs(float(a["loss"]) - float(b["loss"])) \
            <= loss_tol * abs(float(b["loss"]))
    return pstates, jstates


# ---------------------------------------------------------------------------
# the archs: one FedADC configuration each, at reduced()
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_arch_rounds_match_reference(name):
    """qwen3 (dense GQA), zamba2 (Mamba2), whisper (frames through the
    encoder-decoder), internvl2 (the patch prefix, under FedADC+, which
    cuts the patch positions before the KD) and deepseek (MLA, MoE with
    its aux loss)."""
    cfg = get_arch(name).reduced()
    fed = fed_config(distill=name == "internvl2-26b")
    pstates, _ = assert_rounds(cfg, fed)
    for t in jax.tree.leaves(pstates[-1]):
        if isinstance(t, torch.Tensor):
            assert t.dtype == torch.float32 and torch.isfinite(t).all()


# ---------------------------------------------------------------------------
# the strategies, at lm_round's model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(strategy="fedavg"), dict(strategy="slowmo"),
    dict(strategy="fedadc_double"), dict(strategy="fedprox"),
    dict(strategy="fedadc", variant="heavyball"),
    dict(strategy="fedadc+", distill=True),
], ids=["fedavg", "slowmo", "fedadc_double", "fedprox", "heavyball",
        "fedadc_plus"])
def test_strategy_rounds_match_reference(kw):
    """FedADC+ runs the token-level KD (``masked_self_confidence_kd_loss``)
    with the padding label masked out of both its terms and its ρ."""
    assert_rounds(lm_round.model_config(), fed_config(**kw))


def test_mixed_round_keeps_an_fp32_master():
    """The default RunConfig: bf16 broadcast and local steps, fp32 Δ
    accumulation, an fp32 master θ and m."""
    cfg = lm_round.model_config()
    fed = fed_config()
    pstates, _ = assert_rounds(cfg, fed, MIXED, rounds=1, tol=2e-2,
                               loss_tol=1e-3, spacing=bf16_spacing)
    for t in jax.tree.leaves(pstates[-1]["params"]) + jax.tree.leaves(
            pstates[-1]["server"]):
        assert t.dtype == torch.float32
    assert PT._wire_dtype(MIXED) == torch.bfloat16
    assert PT._wire_dtype(FP32) == torch.float32


# ---------------------------------------------------------------------------
# the engine's own contracts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["zamba2-1.2b", "whisper-small"])
def test_remat_full_is_bit_for_bit_none(name):
    """Recomputing each block in the backward pass changes no bit; zamba2
    with a shared attention block between its two Mamba2 blocks."""
    cfg = get_arch(name).reduced()
    if name == "zamba2-1.2b":
        cfg = replace(cfg, block_pattern=(MAMBA2, SHARED_ATTN, MAMBA2))
    fed = fed_config()
    batches = make_batches(cfg, 1)
    jstate0 = reference(cfg, fed, FP32, [])[0][0]
    a, _ = port(cfg, fed, FP32, jstate0, batches)
    b, _ = port(cfg, fed, replace(FP32, remat="full"), jstate0, batches)
    for x, y in zip(jax.tree.leaves(a[-1]["params"]),
                    jax.tree.leaves(b[-1]["params"])):
        assert torch.equal(x, y)


def test_state_shapes_allocates_nothing_and_matches_reference():
    cfg = lm_round.model_config()
    fed = fed_config(compressor="topk", n_clients=6,
                     downlink_compressor="delta+qsgd")
    st = PT.state_shapes(cfg, fed, MIXED)
    ref = JT.state_shapes(jcfg(cfg), JFed(**asdict(fed)),
                          JRun(**asdict(MIXED)))
    assert sorted(st) == sorted(ref) and st["round"] == 0
    got = {"/".join(map(str, p)): (tuple(t.shape), str(t.dtype)[6:])
           for p, t in jax.tree_util.tree_flatten_with_path(
               {k: v for k, v in st.items() if k != "round"})[0]}
    want = {"/".join(map(str, p)): (tuple(t.shape), str(t.dtype))
            for p, t in jax.tree_util.tree_flatten_with_path(
                {k: v for k, v in ref.items() if k != "round"})[0]}
    assert got == want
    assert all(t.device.type == "meta" for t in jax.tree.leaves(st)
               if isinstance(t, torch.Tensor))


def test_token_histogram_matches_reference():
    rng = np.random.RandomState(3)
    tok = rng.randint(0, 50, (2, 3, 7))
    valid = rng.rand(2, 3, 7) > 0.3
    got = PT._token_histogram(torch.from_numpy(tok), 50,
                              torch.from_numpy(valid))
    want = JT._token_histogram(jnp.asarray(tok), 50, jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        PT._token_histogram(torch.from_numpy(tok), 50).numpy(),
        np.asarray(JT._token_histogram(jnp.asarray(tok), 50)))


@pytest.mark.parametrize("kw,match", [
    (dict(strategy="scaffold"), "stateless-client"),
    (dict(strategy="feddyn"), "stateless-client"),
    (dict(strategy="fedavg", aggregator="drag"), "server-momentum"),
    (dict(strategy="fedprox", aggregator="drag"), "server-momentum"),
])
def test_refusals_match_reference(kw, match):
    cfg = lm_round.model_config()
    fed = fed_config(**kw)
    with pytest.raises(ValueError, match=match):
        JT.make_train_step(jcfg(cfg), JFed(**asdict(fed)),
                           JRun(**asdict(FP32)))
    with pytest.raises(ValueError, match=match):
        PT.make_train_step(cfg, fed, FP32)


def test_pod_supported_is_the_reference_tuple():
    assert PT.POD_SUPPORTED == JT.POD_SUPPORTED
