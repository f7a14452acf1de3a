"""The port's analysis (``repro_torch.analysis``): every fixture of the
reference's ``tests/test_analysis.py`` in torch idiom, each rule flagging
or staying clean as the reference's does on its fixture; the baseline
contract on ``analysis_baseline_torch.json``; the run-time audits at tiny
sizes; the CLI's exit codes."""
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.analysis import RULES as R_RULES
from repro.analysis.ast_rules import RepoContext as RContext
from repro.analysis.ast_rules import check_source as r_check_source
from repro_torch.analysis import RULES, load_baseline, run_ast_rules
from repro_torch.analysis.ast_rules import (RepoContext, build_context,
                                            check_source)
from repro_torch.analysis.baseline import Baseline, write_baseline
from repro_torch.analysis.findings import (Finding, findings_to_jsonl,
                                           sort_findings)

ROOT = pathlib.Path(__file__).resolve().parents[1]

CTX = RepoContext(
    numeric_fields=frozenset({"eval_every", "buffer_k", "head_dim"}),
    frozen_configs=frozenset({"FedConfig"}))
R_CTX = RContext(numeric_fields=CTX.numeric_fields,
                 frozen_configs=CTX.frozen_configs)


def _check(src, rule, path="src/repro_torch/fixture.py"):
    return check_source(textwrap.dedent(src), path, ctx=CTX,
                        rules={rule: RULES[rule]})


def _ref(src, rule, path="src/repro/fixture.py"):
    return r_check_source(textwrap.dedent(src), path, ctx=R_CTX,
                          rules={rule: R_RULES[rule]})


# (rule, the reference's fixture, the port's in torch idiom, path or None,
#  findings expected)
FIXTURES = {
    "truthiness_if": ("truthiness-on-config", """
        def f(cfg):
            if cfg.eval_every:
                return 1
    """, None, None, 1),
    "truthiness_or_default": ("truthiness-on-config", """
        def f(cfg):
            k = cfg.buffer_k or 4
            return k
    """, None, None, 1),
    "truthiness_explicit": ("truthiness-on-config", """
        def f(cfg):
            if cfg.eval_every > 0:
                return 1
            k = cfg.buffer_k if cfg.buffer_k > 0 else 4
            return k
    """, None, None, 0),
    "truthiness_non_numeric": ("truthiness-on-config", """
        def f(cfg):
            if cfg.use_pallas:
                return 1
    """, None, None, 0),
    "truthiness_or_final": ("truthiness-on-config", """
        def f(x, cfg):
            return x or cfg.head_dim
    """, None, None, 0),
    "lowp_bf16_sum": ("low-precision-accumulation", """
        import jax.numpy as jnp
        def f(x):
            return jnp.sum(x.astype(jnp.bfloat16))
    """, """
        import torch
        def f(x):
            return torch.sum(x.to(torch.bfloat16))
    """, None, 1),
    "lowp_local_assignment": ("low-precision-accumulation", """
        import jax.numpy as jnp
        def f(x):
            y = x.astype(jnp.bfloat16)
            return jnp.tensordot(w, y, axes=1)
    """, """
        import torch
        def f(x):
            y = x.to(torch.bfloat16)
            return torch.tensordot(w, y, dims=1)
    """, None, 1),
    "lowp_fp32_dtype": ("low-precision-accumulation", """
        import jax.numpy as jnp
        def f(x):
            return jnp.sum(x.astype(jnp.bfloat16), dtype=jnp.float32)
    """, """
        import torch
        def f(x):
            return torch.sum(x.to(torch.bfloat16), dtype=torch.float32)
    """, None, 0),
    "lowp_fp32_accumulate": ("low-precision-accumulation", """
        import jax
        import jax.numpy as jnp
        def f(a, b):
            lo = a.astype(jnp.bfloat16)
            return jax.lax.dot(lo, b,
                               preferred_element_type=jnp.float32)
    """, """
        import torch
        def f(a, b):
            lo = a.to(torch.bfloat16)
            return torch.matmul(lo.float(), b)
    """, None, 0),
    "cache_unannotated": ("unkeyed-config-cache", """
        import functools
        @functools.lru_cache(maxsize=None)
        def make(cfg):
            return cfg
    """, None, None, 1),
    "cache_frozen": ("unkeyed-config-cache", """
        import functools
        @functools.lru_cache(maxsize=None)
        def make(fed: FedConfig):
            return fed
    """, None, None, 0),
    "cache_scalars": ("unkeyed-config-cache", """
        import functools
        @functools.lru_cache(maxsize=None)
        def make(n: int, name: str, frac: float):
            return n
    """, None, None, 0),
    "cache_dict": ("unkeyed-config-cache", """
        import functools
        @functools.lru_cache(maxsize=None)
        def make(spec: dict):
            return spec
    """, None, None, 1),
    "sync_float": ("host-sync-in-jit", """
        import jax
        @jax.jit
        def f(x):
            return float(x)
    """, """
        def make_train_step(cfg):
            def train_step(x):
                return float(x.sum())
            return train_step
    """, None, 1),
    "sync_item_in_returned_def": ("host-sync-in-jit", """
        import jax
        def make_step():
            def step(x):
                return x.item()
            return step
        step = jax.jit(make_step())
    """, """
        def _make_step():
            def step(x):
                return x.item()
            return step
    """, None, 1),
    "sync_outside": ("host-sync-in-jit", """
        def summarize(x):
            return float(x)
    """, None, None, 0),
    "sync_host_call": ("host-sync-in-jit", """
        import jax
        import numpy as np
        @jax.jit
        def f(x):
            return np.mean(x)
    """, """
        import torch
        class Engine:
            def run_round(self, x):
                torch.cuda.synchronize()
                return x.cpu()
    """, None, 2),
    "timer_unbarriered": ("timer-without-barrier", """
        import time
        def bench(f, x):
            t0 = time.perf_counter()
            f(x)
            return time.perf_counter() - t0
    """, None, "benchmarks/bench_fixture.py", 1),
    "timer_barriered": ("timer-without-barrier", """
        import time
        import jax
        def bench(f, x):
            t0 = time.perf_counter()
            jax.block_until_ready(f(x))
            return time.perf_counter() - t0
    """, """
        import time
        import torch
        def bench(f, x):
            t0 = time.perf_counter()
            f(x)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
    """, "benchmarks/bench_fixture.py", 0),
    "timer_scoped": ("timer-without-barrier", """
        import time
        def bench(f, x):
            t0 = time.perf_counter()
            f(x)
            return time.perf_counter() - t0
    """, None, "src/repro/not_a_benchmark.py", 0),
    "acc_append_only": ("unbounded-host-accumulator", """
        class Log:
            def __init__(self):
                self.events = []
            def add(self, e):
                self.events.append(e)
    """, None, None, 1),
    "acc_cleared": ("unbounded-host-accumulator", """
        class Log:
            def __init__(self):
                self.events = []
            def add(self, e):
                self.events.append(e)
            def reset(self):
                self.events.clear()
    """, None, None, 0),
    "acc_rebound": ("unbounded-host-accumulator", """
        class Log:
            def __init__(self):
                self.events = []
            def add(self, e):
                self.events.append(e)
            def flush(self):
                self.events = []
    """, None, None, 0),
    "acc_unbounded_deque": ("unbounded-host-accumulator", """
        from collections import deque
        class Spill:
            def __init__(self):
                self.waiting = deque()
            def push(self, e):
                self.waiting.appendleft(e)
    """, None, None, 1),
    "acc_bounded_deque": ("unbounded-host-accumulator", """
        from collections import deque
        class Spill:
            def __init__(self):
                self.waiting = deque(maxlen=64)
            def push(self, e):
                self.waiting.appendleft(e)
    """, None, None, 0),
    "acc_set_add": ("unbounded-host-accumulator", """
        class Seen:
            def __init__(self):
                self.ids = set()
            def mark(self, i):
                self.ids.add(i)
    """, None, None, 1),
    "acc_ordereddict_popitem": ("unbounded-host-accumulator", """
        from collections import OrderedDict
        class Table:
            def __init__(self):
                self.pages = OrderedDict()
            def admit(self, k, v):
                self.pages[k] = v
                self.pages.update({k: v})
            def evict(self):
                self.pages.popitem(last=False)
    """, None, None, 0),
}


def test_the_reference_rule_ids_are_registered():
    assert set(RULES) == set(R_RULES) == {
        "truthiness-on-config", "low-precision-accumulation",
        "unkeyed-config-cache", "host-sync-in-jit",
        "timer-without-barrier", "unbounded-host-accumulator"}


def test_live_context_introspects_the_ports_configs():
    ctx = build_context()
    assert {"eval_every", "buffer_k", "head_dim"} <= ctx.numeric_fields
    assert "FedConfig" in ctx.frozen_configs
    assert "use_pallas" not in ctx.numeric_fields
    assert "strategy" not in ctx.numeric_fields


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_flags_as_the_reference_does(name):
    rule, ref_src, port_src, path, n = FIXTURES[name]
    ref_path = path or "src/repro/fixture.py"
    port_path = (path or "src/repro_torch/fixture.py").replace(
        "src/repro/", "src/repro_torch/")
    assert len(_ref(ref_src, rule, ref_path)) == (1 if n else 0)
    got = _check(port_src or ref_src, rule, port_path)
    assert len(got) == n, [f.format() for f in got]
    assert all(f.rule == rule for f in got)


def test_host_sync_sees_numpy_values_and_nested_defs():
    got = _check("""
        import numpy as np
        def make_train_step():
            def train_step(x, picks):
                stale = np.asarray(picks)
                def inner(y):
                    return y.tolist()
                return float(stale.mean()), inner(x), float(x.shape[0])
            return train_step
    """, "host-sync-in-jit")
    assert [f.context for f in got] == ["inner"]


def test_timer_takes_the_nearest_start():
    got = _check("""
        import time
        def bench(f, x, dev):
            t0 = time.perf_counter()
            f(x)
            block_until_ready(dev)
            a = time.perf_counter() - t0
            t0 = time.perf_counter()
            f(x)
            return a, time.perf_counter() - t0
    """, "timer-without-barrier", path="src/repro_torch/benchmarks/b.py")
    assert len(got) == 1 and "line 8" in got[0].message


# ---------------------------------------------------------------------------
# baseline contract
# ---------------------------------------------------------------------------
def test_the_ports_tree_is_clean_and_its_baseline_minimal():
    baseline = load_baseline(str(ROOT / "analysis_baseline_torch.json"))
    findings = run_ast_rules(str(ROOT))
    new, suppressed, stale = baseline.apply(findings)
    assert new == [], [f.format() for f in new]
    assert stale == [], stale
    assert len(suppressed) == len(baseline.entries)
    for e in baseline.entries:
        assert e["reason"] and "TODO" not in e["reason"], e


def test_stale_entry_and_line_free_identity():
    b = Baseline(entries=[{
        "rule": "truthiness-on-config", "path": "src/gone.py",
        "context": "", "snippet": "if cfg.rounds:", "reason": "fixture"}])
    new, suppressed, stale = b.apply([])
    assert stale == b.entries and new == [] and suppressed == []
    f1 = Finding("r", "p.py", 10, "msg", context="C.f", snippet="x = 1")
    f2 = Finding("r", "p.py", 99, "other", context="C.f", snippet="x = 1")
    assert f1.key() == f2.key()


def test_baseline_round_trip_and_reasonless_refusal(tmp_path):
    assert load_baseline(str(tmp_path / "nope.json")).entries == []
    p = tmp_path / "b.json"
    f = Finding("rule-x", "a.py", 3, "m", context="g", snippet="s")
    write_baseline(str(p), [f], reason="because")
    new, suppressed, stale = load_baseline(str(p)).apply([f])
    assert new == [] and stale == [] and suppressed[0].suppressed
    p.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "r", "path": "p.py", "context": "", "snippet": "s",
         "reason": ""}]}))
    with pytest.raises(ValueError, match="reason"):
        load_baseline(str(p))


def test_jsonl_rides_the_telemetry_envelope(tmp_path):
    from repro_torch.telemetry.schema import validate_event
    p = tmp_path / "findings.jsonl"
    fs = [Finding("rule-b", "y.py", 2, "m2", suppressed=True),
          Finding("rule-a", "x.py", 1, "m1")]
    assert findings_to_jsonl(sort_findings(fs), str(p), ts=123.0) == 2
    lines = [json.loads(x) for x in p.read_text().splitlines()]
    for ev in lines:
        validate_event(ev)
        assert ev["kind"] == "finding" and ev["engine"] == "analysis"
    assert [e["path"] for e in lines] == ["x.py", "y.py"]


# ---------------------------------------------------------------------------
# the run-time audits
# ---------------------------------------------------------------------------
def test_kernel_coverage_covers_all_eleven_kernels():
    from repro_torch.analysis.trace_audit import (audit_kernel_coverage,
                                                  kernel_table)
    from repro_torch.kernels import ops
    table = kernel_table(str(ROOT / "src/repro_torch/kernels/ops.py"))
    assert table == {n: fn.__name__ for n, fn in ops.KERNELS.items()}
    assert len(table) == 11
    assert audit_kernel_coverage(str(ROOT)) == []


def test_kernel_coverage_detects_a_missing_plain_version(tmp_path):
    from repro_torch.analysis.trace_audit import audit_kernel_coverage
    k = tmp_path / "src" / "repro_torch" / "kernels"
    k.mkdir(parents=True)
    shutil.copy(ROOT / "src/repro_torch/kernels/ops.py", k / "ops.py")
    ref = (ROOT / "src/repro_torch/kernels/ref.py").read_text()
    (k / "ref.py").write_text(ref.replace("def qsgd_quantize(",
                                          "def qsgd_quantise_gone("))
    (tmp_path / "tests").mkdir()
    for p in (ROOT / "tests").glob("test_torch_*.py"):
        shutil.copy(p, tmp_path / "tests" / p.name)
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    got = audit_kernel_coverage(str(tmp_path))
    assert [(f.path, f.context) for f in got] == [
        ("src/repro_torch/kernels/ref.py", "qsgd")]
    (tmp_path / "chip_smoke.py").write_text("")
    got = audit_kernel_coverage(str(tmp_path))
    assert sum(f.path == "chip_smoke.py" for f in got) == 11


def test_accumulation_audit_is_clean_and_flags_a_bf16_sum():
    import torch
    from repro_torch.analysis.trace_audit import (AccumulationAudit,
                                                  audit_accumulation_dtype)
    got = audit_accumulation_dtype()
    assert got == [], [f.format() for f in got]
    bad = []
    x = torch.ones((4, 8), dtype=torch.bfloat16)
    with AccumulationAudit("fixture", bad):
        x.sum(0)
        torch.zeros(8, dtype=torch.bfloat16).add_(x[0])
        x.float().sum(0)
        torch.zeros(8).index_add_(0, torch.arange(8), x[0].float())
    assert len(bad) == 2 and "sum" in bad[0] and "add_" in bad[1]


def test_per_round_audit_is_clean_and_sees_a_round_that_changes():
    import torch
    from repro_torch.analysis import trace_audit as TA
    got = TA.audit_retrace()
    assert got == [], [f.format() for f in got]
    records = []
    rounds = iter([1, 2, 2])

    def uneven(x):
        for _ in range(next(rounds)):
            x = x + 1
        return x
    fn = TA._Rounds(records).wrap(uneven)
    for _ in range(3):
        fn(torch.ones(2))
    assert TA._compare(records, "round", "fixture", "f.py") != []
    assert TA._compare(TA._steady(records), "round", "fixture",
                       "f.py") == []
    # one more bare allocation a round is growth too, and the finding
    # says where in the port it was made
    from repro_torch.kernels import fedadc_update as FU
    records = []
    extra = iter([0, 0, 1])

    def allocating(x):
        for _ in range(next(extra)):
            FU.outputs(4, [((4,), (1,), 0)], torch.float32, "cpu")
        return x + 1
    fn = TA._Rounds(records).wrap(allocating)
    for _ in range(3):
        fn(torch.ones(2))
    got = TA._compare(TA._steady(records), "round", "fixture", "f.py")
    assert len(got) == 1 and "aten.empty" in got[0].message
    assert "kernels/fedadc_update.py:" in got[0].message


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------
def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True,
                          cwd=str(ROOT), env=env, timeout=300)


def test_cli_exit_codes(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.analysis`` once as a process; the other
    cases through ``cli.main``, which the module runs, over the tree's
    findings made once."""
    from repro_torch.analysis import ast_rules
    from repro_torch.analysis.cli import main
    r = _run("--skip-trace", "--require-clean")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 finding(s)" in r.stdout
    found = {}
    run_rules = ast_rules.run_ast_rules

    def once(root, rules=None):
        key = (root, tuple(rules) if rules else None)
        if key not in found:
            found[key] = run_rules(root, rules=rules)
        return list(found[key])
    monkeypatch.setattr(ast_rules, "run_ast_rules", once)
    assert main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in list(RULES) + ["trace-retrace", "trace-kernel-coverage"]:
        assert rid in out
    assert main(["--skip-trace", "--rules", "no-such-rule"]) == 2
    jl = tmp_path / "f.jsonl"
    assert main(["--skip-trace", "--jsonl", str(jl)]) == 0
    lines = [json.loads(x) for x in jl.read_text().splitlines()]
    assert lines and all(e["suppressed"] for e in lines)
    # a stale entry fails --require-clean only
    bl = json.loads((ROOT / "analysis_baseline_torch.json").read_text())
    bl["entries"].append({"rule": "truthiness-on-config", "path": "x.py",
                          "context": "", "snippet": "if cfg.rounds:",
                          "reason": "fixture"})
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps(bl))
    assert main(["--skip-trace", "--baseline", str(stale)]) == 0
    assert main(["--skip-trace", "--require-clean", "--baseline",
                 str(stale)]) == 1
    # a finding the baseline does not cover exits 1; a bad baseline 2
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"version": 1, "entries": []}))
    assert main(["--skip-trace", "--baseline", str(empty)]) == 1
    empty.write_text(json.dumps({"version": 9, "entries": []}))
    assert main(["--skip-trace", "--baseline", str(empty)]) == 2
