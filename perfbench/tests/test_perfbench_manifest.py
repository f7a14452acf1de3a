"""The manifest keeps to the benchmark's contract, the harness imports no
JAX, and the measurement path refuses to run without a card."""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys

from perfbench_tiny import ROOT
from perfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def load_manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_the_allowed_characters():
    m = load_manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in m["configs"]] + \
        [w["name"] for w in m["workloads"]] + \
        [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    names += [w["config"] for w in m["workloads"]]
    names += [w["traffic"] for w in m["workloads"]]
    names += [k for c in m["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    metrics = m["end_to_end"] + m["per_layer"]
    assert len({x["name"] for x in metrics}) == len(metrics)
    assert all(UNIT.match(x["unit"]) for x in metrics)
    assert all(x["better"] in ("lower", "higher") for x in metrics)
    for text in [w["why"] for w in m["workloads"]] + \
            [c["why"] for c in m["configs"]] + \
            [x["layer"] for x in m["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_entry_finds_its_files():
    m = load_manifest()
    bench = ROOT / "perfbench"
    for c in m["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (bench / "engines" / f"{cfg['engine']}.py").exists()
        assert (bench / "reference" / f"{cfg['reference']}.py").exists()
    for w in m["workloads"]:
        assert (bench / "mixes" / f"{w['traffic']}.json").exists()
        assert (bench / "limits" / f"{w['name']}.json").exists()
        assert w["chips"] == 1
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    for x in m["end_to_end"] + m["per_layer"]:
        assert manifest.module(bench, "metrics", x["name"]).read
    for x in m["per_layer"]:
        # a per-layer metric moves an end-to-end metric its cells report
        moved = e2e[x["moves"]]
        for w in x.get("workloads", []):
            assert w in moved.get("workloads", cells)
    for w in cells:
        c = manifest.cell(ROOT, w)
        names = {x["name"] for x in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer and all(x["moves"] in names for x in c.per_layer)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    found = {}
    for path in (ROOT / "perfbench").rglob("*.py"):
        bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
        if bad:
            found[str(path)] = bad
    assert found == {}
    # the port's name begins with the JAX package's: compared whole
    assert "repro_torch".split(".")[0] not in FORBIDDEN


def _run(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "zamba2-1.2b.fedadc", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def _printed_a_result(stdout):
    return any(line.startswith("{") for line in stdout.splitlines())


def test_the_measurement_path_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        return
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert not _printed_a_result(proc.stdout)
    assert "no CUDA device" in proc.stderr


def test_the_harness_alone_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _printed_a_result(proc.stdout)
