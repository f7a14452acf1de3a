"""The comparison that decides ``correct`` fails what it must: the
control (the reference at the precision below the configuration's, in
the program's place) and each fault a training cell can have, planted
under the timed path, at tiny sizes on the CPU.  The card's look is
skipped; the rest of a run is the run's own."""
from __future__ import annotations

import json
import time

import pytest

from perfbench import bench
from perfbench_tiny import ROOT

CELLS = ["zamba2-1.2b.fedadc", "resnet18-cifar100.fedadc"]
CONTROLS = [(w, c) for w in CELLS for c in json.loads(
    (ROOT / "perfbench" / "configs" / f"{w.rsplit('.', 1)[0]}.json")
    .read_text())["controls"]]


def run(root, workload, **kw):
    return bench.run_cell(root, workload, 2 ** 31 + 4242, 0.2, False,
                          time.perf_counter(), device="cpu",
                          bench=root / "perfbench", **kw)


@pytest.mark.parametrize("workload,control", CONTROLS)
def test_the_control_is_not_correct(tiny, workload, control):
    out = run(tiny, workload, reference=control)
    assert not out["result"]["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "loss"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(tiny, workload, fault):
    out = run(tiny, workload, fault=fault)
    assert not out["result"]["correct"], (fault, out["checks"])


def test_half_of_one_sequence_a_step_is_not_correct(tiny):
    """At one sequence a local step (zamba2's b 1) half the batch is half
    of each sequence's tokens."""
    path = tiny / "perfbench" / "configs" / "zamba2-1.2b.json"
    cfg = json.loads(path.read_text())
    cfg["round"].update(b=1, L=128)
    path.write_text(json.dumps(cfg))
    assert run(tiny, "zamba2-1.2b.fedadc")["result"]["correct"]
    out = run(tiny, "zamba2-1.2b.fedadc", fault="half")
    assert not out["result"]["correct"], out["checks"]
