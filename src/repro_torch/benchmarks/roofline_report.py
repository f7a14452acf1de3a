"""Aggregate the port's dry-run results
(``results/baseline_{singlepod,multipod}_torch.jsonl``, written by
``python -m repro_torch.launch.dryrun --out ...``) into the roofline table
(counterpart of ``benchmarks/roofline_report.py``): three terms, dominant
bottleneck, MODEL_FLOPS ratio.  Rows are the reference's:
``roofline.<mesh>.<arch>.<shape>``, µs the dry-run's counting seconds,
derived ``dom=...;compute_s=...;memory_s=...;collective_s=...;
hbm_gb=...;useful=...``.  A missing file gives no rows."""
import json
import os

from repro_torch.benchmarks.common import emit

RESULTS = [("singlepod", "results/baseline_singlepod_torch.jsonl"),
           ("multipod", "results/baseline_multipod_torch.jsonl")]


def load(path):
    if not os.path.exists(path):
        return []
    seen = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            seen[(r["arch"], r["shape"])] = r     # last write wins
    return list(seen.values())


def rows_of(records, mesh_name, rows):
    for r in records:
        key = f"roofline.{mesh_name}.{r['arch']}.{r['shape']}"
        if r["status"] != "ok":
            rows.append(emit(key, 0, f"status={r['status']}"))
            continue
        derived = (f"dom={r['dominant']};compute_s={r['compute_s']:.3g};"
                   f"memory_s={r['memory_s']:.3g};"
                   f"collective_s={r['collective_s']:.3g};"
                   f"hbm_gb={r['per_device_hbm_gb']:.2f};"
                   f"useful={min(r.get('useful_flop_frac', 0), 99):.2f}")
        rows.append(emit(key, r["t_compile_s"] * 1e6, derived))
    return rows


def main(rows=None, device=None, results=None):
    """``device`` is the harness's and unused: the report reads files.
    ``results`` replaces ``RESULTS``' (mesh name, path) pairs."""
    rows = rows if rows is not None else []
    for mesh_name, path in (RESULTS if results is None else results):
        rows_of(load(path), mesh_name, rows)
    return rows


if __name__ == "__main__":
    main()
