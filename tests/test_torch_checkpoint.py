"""The port's checkpoints against the JAX package's: the same npz layout
(keys joined from the tree path, bf16 and fp8 stored as the bits of a
same-width uint), so a checkpoint written by either package restores in
the other, and every dtype round-trips bit for bit."""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as jckpt
from repro_torch.checkpointing import checkpoint as ckpt

DTYPES = {  # torch dtype -> the reference's numpy dtype
    "float32": (torch.float32, np.float32),
    "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16),
    "float8_e4m3fn": (torch.float8_e4m3fn, ml_dtypes.float8_e4m3fn),
    "float8_e5m2": (torch.float8_e5m2, ml_dtypes.float8_e5m2),
}


def bits(t):
    return ckpt.storage_view(t).tobytes()


def trees(dtype_name, seed=0):
    """The same values as a port tree and a reference tree: fp32 draws
    rounded to the dtype, with -0.0 and the smallest subnormal planted."""
    tdt, ndt = DTYPES[dtype_name]
    rng = np.random.RandomState(seed)
    w = rng.randn(6, 5).astype(np.float32)
    w[0, 0] = -0.0
    b = rng.randn(7).astype(np.float32)
    port = {"layer": {"w": torch.from_numpy(w).to(tdt),
                      "b": torch.from_numpy(b).to(tdt)},
            "m": torch.from_numpy(rng.randn(3).astype(np.float32))}
    tiny = torch.finfo(tdt).smallest_normal / 2
    port["layer"]["b"][1] = tiny
    ref = {"layer": {k: np.frombuffer(bits(v), dtype=ndt).reshape(v.shape)
                     for k, v in port["layer"].items()},
           "m": port["m"].numpy().copy()}
    return port, ref


def flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], path + (k,))]
    return [(path, tree)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_round_trip_bit_for_bit(tmp_path, dtype):
    port, _ = trees(dtype)
    ckpt.save_checkpoint(str(tmp_path), 7, port)
    got = ckpt.restore_checkpoint(str(tmp_path), 7, port)
    for (p, a), (q, b) in zip(flat(got), flat(port)):
        assert p == q and a.dtype == b.dtype and bits(a) == bits(b)
    assert [f for f in os.listdir(tmp_path)] == ["ckpt_00000007.npz"]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    port, ref = trees(dtype)
    jckpt.save_checkpoint(str(tmp_path), 3, {
        "layer": {k: jnp.asarray(v) for k, v in ref["layer"].items()},
        "m": jnp.asarray(ref["m"])})
    like = {"layer": {k: torch.zeros_like(v)
                      for k, v in port["layer"].items()},
            "m": torch.zeros_like(port["m"])}
    got = ckpt.restore_checkpoint(str(tmp_path), 3, like)
    for (_, a), (_, b) in zip(flat(got), flat(port)):
        assert a.dtype == b.dtype and bits(a) == bits(b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_checkpoint_restores_in_the_reference(tmp_path, dtype):
    port, ref = trees(dtype)
    ckpt.save_checkpoint(str(tmp_path), 5, port)
    got = jckpt.restore_checkpoint(str(tmp_path), 5, ref)
    for (_, a), (_, b) in zip(flat(got), flat(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        assert jckpt.storage_view(a).tobytes() == \
            jckpt.storage_view(b).tobytes()


def test_storage_dtypes_match_reference():
    for tdt, ndt in DTYPES.values():
        assert ckpt.storage_dtype(tdt) == jckpt.storage_dtype(ndt)
    assert ckpt.storage_dtype(torch.int64) == np.int64


def test_latest_step_and_mismatch(tmp_path):
    port, _ = trees("float32")
    assert ckpt.latest_step(str(tmp_path / "none")) is None
    for step in (2, 10, 4):
        ckpt.save_checkpoint(str(tmp_path), step, port)
    assert ckpt.latest_step(str(tmp_path)) == 10
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore_checkpoint(str(tmp_path), 10, {"m": port["m"]})
    bad = {"layer": {"w": torch.zeros(5, 6), "b": port["layer"]["b"]},
           "m": port["m"]}
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path), 10, bad)


def test_restore_takes_the_like_device_and_sequences(tmp_path):
    tree = {"a": [torch.arange(4), torch.ones(2, dtype=torch.bfloat16)]}
    ckpt.save_checkpoint(str(tmp_path), 0, tree)
    with np.load(tmp_path / "ckpt_00000000.npz") as data:
        assert sorted(data.files) == ["a|0", "a|1"]
        assert data["a|1"].dtype == np.uint16
    got = ckpt.restore_checkpoint(str(tmp_path), 0, tree)
    assert isinstance(got["a"], list)
    assert all(bits(a) == bits(b) for a, b in zip(got["a"], tree["a"]))
