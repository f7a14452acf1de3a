"""Rules of the PyTorch port: it imports neither JAX nor the JAX package
nor the reference's top-level ``benchmarks``, and its entry points run on
the card unless asked for the CPU."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs.base import FedConfig
from repro_torch.data.partition import sort_and_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.simulator import FederatedSimulator, SimConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro|benchmarks)\b|"
                       r"from\s+(jax|repro|benchmarks)[\s.])", re.MULTILINE)


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_the_port_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro', "
            "'benchmarks')\n"
            "       or m.startswith(('jax.', 'repro.', 'benchmarks.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_no_file_of_the_port_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f) for f in files if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_simulator_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, xt, yt = make_image_dataset(40, 10, 10, image_size=16)
    parts = sort_and_partition(y, 4, s=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FederatedSimulator(FedConfig(n_clients=4, clients_per_round=2),
                           SimConfig(cnn_width=8), x, y, xt, yt, parts)
    sim = FederatedSimulator(FedConfig(n_clients=4, clients_per_round=2),
                             SimConfig(cnn_width=8), x, y, xt, yt, parts,
                             device="cpu")
    assert all(t.device.type == "cpu" for t in sim.params["c1"].values())


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No card: the script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          capture_output=True, text=True, env=env,
                          cwd=tmp_path, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
