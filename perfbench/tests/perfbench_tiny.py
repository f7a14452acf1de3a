"""Helpers of the benchmark's tests: a copy of the harness in a temporary
checkout whose cells are cut to sizes the CPU runs in seconds (the same
files, with the configurations' sizes replaced)."""
from __future__ import annotations

import json
import math
import shutil
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY_ZAMBA = {
    "family": "hybrid", "n_layers": 2, "shared_attn_every": 2, "d_model": 64, "n_heads": 4,
    "n_kv_heads": 4, "head_dim": 16, "d_ff": 128, "vocab_size": 256,
    "ssm": {"d_state": 16, "d_conv": 4, "expand": 2, "n_groups": 1,
            "head_dim": 16, "chunk_size": 32},
    "tie_embeddings": True, "norm_eps": 1e-05, "rope_theta": 10000.0,
    "max_seq_len": 256}
TINY_ZAMBA_ROUND = {"CP": 1, "CS": 2, "H": 2, "b": 2, "L": 64}
TINY_RESNET_DATA = {"kind": "images", "n_train": 240, "image_size": 8,
                    "n_classes": 10, "n_modes": 3, "noise": 0.35,
                    "n_clients": 6, "alpha": 0.3}
TINY_RESNET_ROUND = {"clients": 2, "H": 2, "b": 4}


def _count(layout):
    return sum(math.prod(s) for s, _, _ in layout.values())


def write_tiny(root: Path):
    """Cut the copy's two configurations to tiny sizes in place."""
    from perfbench.reference import resnet18, zamba2
    cdir = root / "perfbench" / "configs"
    z = json.loads((cdir / "zamba2-1.2b.json").read_text())
    z["model"] = TINY_ZAMBA
    z["round"] = TINY_ZAMBA_ROUND
    z["data"] = {"kind": "tokens", "docs": 16, "n_domains": 4}
    z["params"] = _count(zamba2.layout(TINY_ZAMBA))
    (cdir / "zamba2-1.2b.json").write_text(json.dumps(z))
    r = json.loads((cdir / "resnet18-cifar100.json").read_text())
    r["model"]["n_classes"] = 10
    r["data"] = TINY_RESNET_DATA
    r["round"] = TINY_RESNET_ROUND
    r["params"] = _count(resnet18.layout(r["model"]))
    (cdir / "resnet18-cifar100.json").write_text(json.dumps(r))


def copy_checkout(dst: Path) -> Path:
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst
