"""A configuration, a traffic mix (with another strategy, its round
reference and further round inputs), a per-layer metric and a cell added
as new files and new manifest entries run without an edit to any file the
harness had; a mix with no round reference for its strategy is refused."""
from __future__ import annotations

import hashlib
import json
import time

import pytest

from perfbench import bench


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tiny):
    b = tiny / "perfbench"
    before = digests(b)
    conf = json.loads((b / "configs" / "zamba2-1.2b.json").read_text())
    conf["name"] = "zamba2-tiny-wide"
    conf["model"]["d_ff"] = 192
    from perfbench.reference import zamba2
    import math
    conf["params"] = sum(math.prod(s) for s, _, _ in
                         zamba2.layout(conf["model"]).values())
    (b / "configs" / "zamba2-tiny-wide.json").write_text(json.dumps(conf))
    mix = json.loads((b / "mixes" / "fedadc.json").read_text())
    mix["name"], mix["fed"]["eta"] = "fedadc-eta2", 0.02
    mix["round"] = {"pod": {"H": 1}}
    (b / "mixes" / "fedadc-eta2.json").write_text(json.dumps(mix))
    (b / "metrics" / "rounds_in_window.py").write_text(
        '"""Rounds the window completed."""\n\n\n'
        'def read(ctx):\n    return float(ctx.window["rounds"])\n')
    (b / "limits" / "zamba2-tiny-wide.fedadc-eta2.json").write_text(
        json.dumps({"loss": 0.05, "grad": 0.5, "change": 0.5}))
    man = json.loads((tiny / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "zamba2-tiny-wide", "source": "test",
                           "file": "perfbench/configs/zamba2-tiny-wide.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "zamba2-tiny-wide.fedadc-eta2",
                             "config": "zamba2-tiny-wide",
                             "traffic": "fedadc-eta2", "chips": 1,
                             "why": "test"})
    man["per_layer"].append({"name": "rounds_in_window", "unit": "rounds",
                             "better": "higher", "source": "host_clock",
                             "layer": "round engine", "moves": "round_s",
                             "workloads": ["zamba2-tiny-wide.fedadc-eta2"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(man))

    out = bench.run_cell(tiny, "zamba2-tiny-wide.fedadc-eta2", 2 ** 31 + 7,
                         0.2, True, time.perf_counter(), device="cpu",
                         bench=b)
    assert out["result"]["correct"], out["checks"]
    metrics = out["result"]["metrics"]
    assert metrics["rounds_in_window"]["value"] >= 1
    assert "host_ms_per_round" in metrics and "mfu" in metrics
    after = digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


SLOWMO_REFERENCE = '''"""SlowMo rounds: FedADC's with no local momentum (beta_local 0)."""
from perfbench.reference import fedadc

first_gradient = fedadc.first_gradient


def covers(fed):
    return None if fed.get("strategy") == "slowmo" else "not SlowMo"


def run(loss, params0, rounds, fed, dtypes):
    return fedadc.run(loss, params0, rounds, {**fed, "beta_local": 0.0},
                      dtypes)
'''


def add_cell(root, workload, config, mix, limits):
    (root / "perfbench" / "limits" / f"{workload}.json").write_text(
        json.dumps(limits))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": workload, "config": config,
                             "traffic": mix, "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))


def test_a_mix_of_another_strategy_with_a_round_input_is_new_files(tiny):
    """Another strategy, its round reference and a further round input
    (each round's client ids from a pool), from new files alone."""
    b = tiny / "perfbench"
    before = digests(b)
    (b / "reference" / "slowmo.py").write_text(SLOWMO_REFERENCE)
    mix = json.loads((b / "mixes" / "fedadc.json").read_text())
    mix.update(name="slowmo", reference="slowmo",
               inputs={"client_ids": {"pool": 6}})
    mix["fed"]["strategy"] = "slowmo"
    (b / "mixes" / "slowmo.json").write_text(json.dumps(mix))
    add_cell(tiny, "zamba2-1.2b.slowmo", "zamba2-1.2b", "slowmo",
             {"loss": 0.05, "grad": 0.5, "change": 0.5})
    out = bench.run_cell(tiny, "zamba2-1.2b.slowmo", 2 ** 31 + 11, 0.2,
                         False, time.perf_counter(), device="cpu", bench=b)
    assert out["result"]["correct"], out["checks"]
    # SlowMo's rounds differ from FedADC's: the FedADC reference in its
    # place reads far off
    fedadc = bench.run_cell(tiny, "zamba2-1.2b.fedadc", 2 ** 31 + 11, 0.2,
                            False, time.perf_counter(), device="cpu", bench=b)
    assert fedadc["readings"]["program"]["loss"][1:] != \
        out["readings"]["program"]["loss"][1:]
    after = digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("case", ["uncovered", "unnamed"])
def test_a_mix_without_its_round_reference_is_refused(tiny, case):
    b = tiny / "perfbench"
    mix = json.loads((b / "mixes" / "fedadc.json").read_text())
    mix["name"] = "other"
    if case == "uncovered":
        mix["fed"].update(compressor="topk", topk_frac=0.1)
    else:
        del mix["reference"]
    (b / "mixes" / "other.json").write_text(json.dumps(mix))
    add_cell(tiny, "zamba2-1.2b.other", "zamba2-1.2b", "other",
             {"loss": 0.05, "grad": 0.5, "change": 0.5})
    with pytest.raises(SystemExit, match="reference"):
        bench.run_cell(tiny, "zamba2-1.2b.other", 2 ** 31 + 12, 0.2, False,
                       time.perf_counter(), device="cpu", bench=b)
