"""``BENCHMARK.json`` and the files it names.

The harness is driven by data.  Every name in the manifest leads to files
of its own, found by that name:

* a configuration: the ``file`` its entry gives (``configs/<name>.json``),
  whose ``engine`` names ``engines/<engine>.py`` and whose ``reference``
  names ``reference/<reference>.py``;
* a traffic mix: ``mixes/<traffic>.json``, whose ``reference`` names the
  plain round reference it is judged by, ``reference/<reference>.py``
  (``round_reference``);
* a metric, end-to-end or per-layer: ``metrics/<name>.py`` with
  ``read(ctx)``;
* a cell's comparison limits: ``limits/<workload>.json``.

A later change adds a configuration, a mix, a metric or a cell as new
files and new manifest entries, and edits none of these.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    bench: Path           # the harness's folder
    config: Dict
    mix: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    chips: int

    @property
    def round(self) -> Dict:
        """The round's shape: the configuration's, with the mix's
        overrides for this engine."""
        over = self.mix.get("round", {}).get(self.config["engine"], {})
        return {**self.config["round"], **over}

    def dtypes(self, control: Optional[str] = None) -> Dict:
        """The dtypes a round reference keeps its state in (``master``,
        ``local``) and computes the forward in (``compute``): the
        configuration's ``precision``, or one of its ``controls`` over it."""
        import torch
        p = {**self.config["precision"],
             **(self.config["controls"][control] if control else {})}
        return {"master": getattr(torch, p["param_dtype"]),
                "local": getattr(torch, p["local_dtype"]),
                "compute": getattr(torch, p["reference_compute_dtype"])}


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(root: Path, workload: str, bench: Path = HERE) -> Cell:
    man = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    mix = load_json(bench / "mixes" / f"{w['traffic']}.json")
    limits = load_json(bench / "limits" / f"{workload}.json")
    e2e = [m for m in man["end_to_end"] if _applies(m, workload)]
    moved = {m["name"] for m in e2e}
    # a per-layer metric without a ``workloads`` key is read in every cell
    # that reports the end-to-end metric it moves
    per_layer = [m for m in man["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(workload, bench, config, mix, limits, e2e, per_layer,
                int(w["chips"]))


def module(bench: Path, folder: str, name: str):
    """``<bench>/<folder>/<name>.py`` as a module."""
    path = bench / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{name.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def round_reference(cell: Cell):
    """The plain round reference that the cell's mix names.  Refuses a mix
    that names none, one that is not there, or one that does not follow
    the mix's strategy and wire (its ``covers(fed)`` says why)."""
    name = cell.mix.get("reference")
    if not name or not (cell.bench / "reference" / f"{name}.py").is_file():
        raise SystemExit(f"mix {cell.mix.get('name')!r} names no plain round "
                         f"reference under reference/ ({name!r}): no cell "
                         f"runs without one")
    ref = module(cell.bench, "reference", name)
    why = ref.covers(cell.mix["fed"])
    if why:
        raise SystemExit(f"mix {cell.mix.get('name')!r}: {why}")
    return ref
