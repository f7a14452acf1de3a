"""The port's serving stack (the three serve steps, sampling, the cache
manager, the scheduler and the continuous-batching engine, and the latency
summary) held against the JAX package on the CPU.

Parameters come from the reference's init, converted leaf for leaf.  The
engine's tokens must equal the reference engine's exactly: greedy, and
sampled when the port is handed the reference's own Gumbel draws
(``gumbel_fn``), since no torch generator gives JAX's threefry bits.  The
port holds the reference's own promises too: a request's tokens are the
same batched as alone, and the same for any prefill chunk size.

The hybrid config is ``reduced()`` zamba2 with an explicit block pattern
holding ``SHARED_ATTN`` (Mamba2 state pages plus shared-attention KV
pages).
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro.models import transformer as jT
from repro.serving import CacheManager as JCacheManager
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import SchedulerConfig as JSchedulerConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import sample_tokens as jsample_tokens
from repro.telemetry import latency_summary as jlatency_summary
from repro_torch import convert, serve_demo
from repro_torch.configs import get_arch
from repro_torch.configs.base import MAMBA2, SHARED_ATTN
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serving import (CacheManager, SamplingParams,
                                 SchedulerConfig, ServingEngine,
                                 latency_summary, sample_tokens)
from repro_torch.serving.request import RequestOutput
from repro_torch.serving.sampling import gumbel_noise

MAX_LEN = 96


def hybrid():
    return replace(get_arch("zamba2-1.2b").reduced(),
                   block_pattern=(MAMBA2, MAMBA2, SHARED_ATTN, MAMBA2,
                                  SHARED_ATTN))


def jcfg(cfg):
    from repro.configs import base as jbase
    kw = dataclasses.asdict(cfg)
    if kw["ssm"] is not None:
        kw["ssm"] = jbase.SSMConfig(**kw["ssm"])
    return jbase.ModelConfig(**kw)


@pytest.fixture(scope="module")
def model():
    cfg = hybrid()
    jp = jax.jit(lambda k: jT.init(k, jcfg(cfg)))(jax.random.PRNGKey(0))
    return cfg, convert.from_numpy(jax.tree.map(np.asarray, jp), "cpu"), jp


def prompts(cfg, n, seed=0, lo=3, hi=24):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def sched(n_slots, chunk=8):
    return SchedulerConfig(n_slots=n_slots, max_len=MAX_LEN,
                           prefill_chunk=chunk, page_size=16)


def jsched(n_slots, chunk=8):
    return JSchedulerConfig(n_slots=n_slots, max_len=MAX_LEN,
                            prefill_chunk=chunk, page_size=16)


def reference_gumbel(seeds, counters, vocab, device):
    """The reference's per-row draws: gumbel(fold_in(PRNGKey(seed),
    counter)), as ``serving/sampling.py`` makes them."""
    g = jax.vmap(lambda s, c: jax.random.gumbel(
        jax.random.fold_in(jax.random.PRNGKey(s), c), (vocab,),
        jnp.float32))(jnp.asarray(seeds, jnp.int32),
                      jnp.asarray(counters, jnp.int32))
    return torch.from_numpy(np.array(g)).to(device)


def port_tokens(cfg, params, ps, n_slots, gen=8, chunk=8, sampling=None,
                **kw):
    eng = ServingEngine(cfg, params=params, sched=sched(n_slots, chunk),
                        device="cpu", **kw)
    for i, p in enumerate(ps):
        eng.add_request(p, max_new_tokens=gen,
                        sampling=sampling(i) if sampling else None)
    return [o.tokens for o in eng.run()]


def ref_tokens(cfg, jp, ps, n_slots, gen=8, chunk=8, sampling=None):
    eng = JServingEngine(jcfg(cfg), params=jp, sched=jsched(n_slots, chunk))
    for i, p in enumerate(ps):
        eng.add_request(p, max_new_tokens=gen,
                        sampling=sampling(i) if sampling else None)
    return [o.tokens for o in eng.run()]


# ---------------------------------------------------------------------------
# the serve steps
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_step_matches_reference(model, use_pallas):
    cfg, p, jp = model
    t = np.random.RandomState(3).randint(0, cfg.vocab_size, (3, 64))
    got = serve.make_prefill_step(cfg, use_pallas)(
        p, {"tokens": torch.from_numpy(t)})
    want = jserve.make_prefill_step(jcfg(cfg), use_pallas)(
        jp, {"tokens": jnp.asarray(t, jnp.int32)})
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_step_matches_reference(model):
    cfg, p, jp = model
    t = np.random.RandomState(4).randint(0, cfg.vocab_size, (2, 1))
    cache = T.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    jcache = jT.init_cache(jcfg(cfg), 2, 16, jnp.float32)
    pos, active = np.array([0, 3]), np.array([True, False])
    lg, new = serve.make_serve_step(cfg)(p, cache, torch.from_numpy(t),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(active))
    jlg, jnew = jserve.make_serve_step(jcfg(cfg))(
        jp, jcache, jnp.asarray(t, jnp.int32), jnp.asarray(pos, jnp.int32),
        jnp.asarray(active))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5,
                               rtol=1e-5)
    for ri in jnew:
        for k in jnew[ri]:
            np.testing.assert_allclose(new[ri][k].numpy(),
                                       np.asarray(jnew[ri][k]), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("n_valid", [8, 5])
def test_prefill_chunk_step_matches_reference(model, n_valid):
    """A full and a partial chunk at position 4: the last valid token's
    logits, and the padding steps write nothing."""
    cfg, p, jp = model
    t = np.random.RandomState(5).randint(0, cfg.vocab_size, (1, 8))
    cache = T.init_cache(cfg, 1, 32, torch.float32, device="cpu")
    jcache = jT.init_cache(jcfg(cfg), 1, 32, jnp.float32)
    last, new = serve.make_prefill_chunk_step(cfg, 8)(
        p, cache, torch.from_numpy(t), 4, n_valid)
    jlast, jnew = jax.jit(jserve.make_prefill_chunk_step(jcfg(cfg), 8))(
        jp, jcache, jnp.asarray(t, jnp.int32), jnp.int32(4),
        jnp.int32(n_valid))
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-5,
                               rtol=1e-5)
    for ri in jnew:
        for k in jnew[ri]:
            np.testing.assert_allclose(new[ri][k].numpy(),
                                       np.asarray(jnew[ri][k]), atol=1e-5,
                                       rtol=1e-5)


def test_cache_shapes_match_reference(model):
    cfg = model[0]
    got = serve.cache_shapes(cfg, 4, 64)
    want = jserve.cache_shapes(jcfg(cfg), 4, 64)
    for ri in want:
        for k in want[ri]:
            assert got[ri][k].device.type == "meta"
            assert tuple(got[ri][k].shape) == want[ri][k].shape
            assert str(got[ri][k].dtype).replace("torch.", "") == \
                str(want[ri][k].dtype)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------
def test_sample_tokens_matches_reference_under_its_draws():
    rng = np.random.RandomState(6)
    B, V = 8, 50
    logits = rng.randn(B, V).astype(np.float32)
    logits[1, 7] = logits[1, 30] = logits[1].max() + 1.0   # greedy tie
    logits[5, :6] = logits[5].max() + 0.5                  # top-k tie
    temps = np.array([0, 0, 0.5, 1.0, 0.8, 1.0, 2.0, 0.8], np.float32)
    top_ks = np.array([0, 0, 1, 5, 50, 3, 0, 40], np.int32)
    seeds = np.arange(B, dtype=np.int32) * 7
    counters = np.array([0, 1, 2, 3, 4, 5, 6, 7], np.int32)
    draws = reference_gumbel(seeds, counters, V, "cpu")
    got = sample_tokens(torch.from_numpy(logits), torch.from_numpy(temps),
                        torch.from_numpy(top_ks), seeds, counters,
                        gumbel=draws)
    want = jsample_tokens(jnp.asarray(logits), jnp.asarray(temps),
                          jnp.asarray(top_ks), jnp.asarray(seeds),
                          jnp.asarray(counters))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1] == 7


def test_default_draws_depend_on_seed_and_position_only():
    alone = gumbel_noise([3], [5], 40, "cpu")
    batched = gumbel_noise([9, 3, 3], [5, 5, 6], 40, "cpu")
    assert torch.equal(alone[0], batched[1])
    assert not torch.equal(batched[1], batched[2])
    assert not torch.equal(batched[0], batched[1])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
def test_engine_greedy_matches_reference_and_alone(model):
    cfg, p, jp = model
    ps = prompts(cfg, 5)
    want = ref_tokens(cfg, jp, ps, n_slots=4)
    batched = port_tokens(cfg, p, ps, n_slots=4)
    alone = port_tokens(cfg, p, ps, n_slots=1)
    assert batched == want
    assert alone == batched


def test_engine_sampling_matches_reference_under_its_draws(model):
    cfg, p, jp = model
    ps = prompts(cfg, 4, seed=1)
    want = ref_tokens(cfg, jp, ps, n_slots=3, sampling=lambda i: JSamplingParams(
        temperature=0.8, top_k=40, seed=i))
    got = port_tokens(cfg, p, ps, n_slots=3, sampling=lambda i: SamplingParams(
        temperature=0.8, top_k=40, seed=i), gumbel_fn=reference_gumbel)
    assert got == want
    alone = port_tokens(cfg, p, ps, n_slots=1, sampling=lambda i: SamplingParams(
        temperature=0.8, top_k=40, seed=i), gumbel_fn=reference_gumbel)
    assert alone == got


def test_engine_default_sampling_is_batch_independent(model):
    cfg, p, _ = model
    ps = prompts(cfg, 4, seed=2)
    sp = lambda i: SamplingParams(temperature=1.0, top_k=20, seed=i)  # noqa: E731
    assert port_tokens(cfg, p, ps, 4, sampling=sp) == \
        port_tokens(cfg, p, ps, 1, sampling=sp)


def test_prefill_chunk_size_invariant(model):
    cfg, p, _ = model
    ps = prompts(cfg, 3, seed=1, lo=5, hi=30)
    assert port_tokens(cfg, p, ps, 2, chunk=4) == \
        port_tokens(cfg, p, ps, 2, chunk=64)


def test_more_requests_than_slots_all_complete_fifo(model):
    cfg, p, _ = model
    eng = ServingEngine(cfg, params=p, sched=sched(2), device="cpu")
    rids = [eng.add_request(q, max_new_tokens=5) for q in prompts(cfg, 7)]
    outs = eng.run()
    assert [o.rid for o in outs] == rids
    assert all(len(o.tokens) == 5 for o in outs)
    assert not eng.has_work()
    assert eng.cachemgr.free_pages == eng.cachemgr.total_pages


def test_mid_flight_admission(model):
    cfg, p, _ = model
    ps = prompts(cfg, 3, seed=2)
    alone = port_tokens(cfg, p, ps, 1, gen=12)
    eng = ServingEngine(cfg, params=p, sched=sched(4), device="cpu")
    eng.add_request(ps[0], max_new_tokens=12)
    eng.add_request(ps[1], max_new_tokens=12)
    outs = []
    for _ in range(6):
        outs.extend(eng.step())
    eng.add_request(ps[2], max_new_tokens=12)   # mid-flight
    while eng.has_work():
        outs.extend(eng.step())
    got = {o.rid: o.tokens for o in outs}
    assert [got[i] for i in range(3)] == alone


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "qwen3-4b"])
def test_page_accounting_matches_reference(model, arch):
    cfg = hybrid() if arch == "zamba2-1.2b" else get_arch(arch).reduced()
    mgr = CacheManager(cfg, 3, 64, page_size=16, device="cpu")
    jmgr = JCacheManager(jcfg(cfg), 3, 64, page_size=16)
    assert (mgr.has_kv, mgr.has_state, mgr.total_pages) == \
        (jmgr.has_kv, jmgr.has_state, jmgr.total_pages)
    for n in (1, 16, 17, 64, 100):
        assert mgr.pages_for(n) == jmgr.pages_for(n)
    slots = [mgr.admit(40), mgr.admit(10)]
    jslots = [jmgr.admit(40), jmgr.admit(10)]
    assert slots == jslots and mgr.free_pages == jmgr.free_pages
    assert mgr.can_admit(64) == jmgr.can_admit(64)
    mgr.free(slots[0])
    jmgr.free(jslots[0])
    assert mgr.free_pages == jmgr.free_pages


def test_admit_resets_the_slot_in_place(model):
    cfg = model[0]
    mgr = CacheManager(cfg, 2, 32, page_size=16, device="cpu")
    leaf = mgr.cache["1"]["kpos"]
    leaf.fill_(5)
    slot = mgr.admit(10)
    assert mgr.cache["1"]["kpos"] is leaf
    assert (leaf[:, slot] == -1).all() and (leaf[:, 1 - slot] == 5).all()


def test_engine_rejects_encdec_and_overlong(model):
    with pytest.raises(ValueError, match="decoder-only"):
        ServingEngine(get_arch("whisper-small").reduced(), device="cpu")
    cfg, p, _ = model
    eng = ServingEngine(cfg, params=p, sched=sched(1), device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.add_request(list(range(MAX_LEN)), max_new_tokens=8)


def test_engine_and_demo_without_a_device_raise_when_cuda_is_absent(
        monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model[0], params=model[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_demo.main(["--gen", "2"])


def test_serve_demo_runs_both_paths_on_the_cpu():
    gen = serve_demo.main(["--device", "cpu", "--batch", "2",
                           "--prompt-len", "6", "--gen", "3"])
    assert tuple(gen.shape) == (2, 4)
    outs = serve_demo.main(["--device", "cpu", "--engine", "--batch", "2",
                            "--prompt-len", "6", "--gen", "3"])
    assert len(outs) == 4 and all(len(o.tokens) == 3 for o in outs)


# ---------------------------------------------------------------------------
# latency
# ---------------------------------------------------------------------------
def test_latency_summary_matches_reference():
    from repro.serving.request import RequestOutput as JRequestOutput
    rng = np.random.RandomState(8)
    outs, jouts = [], []
    for rid in range(7):
        a = float(rng.rand())
        f = a + float(rng.rand())
        e = f + float(rng.rand())
        toks = list(range(1 + rid % 3))
        outs.append(RequestOutput(rid, [1], toks, a, f, e))
        jouts.append(JRequestOutput(rid, [1], toks, a, f, e))
    assert latency_summary(outs) == jlatency_summary(jouts)
    with pytest.raises(ValueError):
        latency_summary([])
