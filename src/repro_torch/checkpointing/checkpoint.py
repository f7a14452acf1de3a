"""Flat-npz checkpoints of trees of tensors (counterpart of the JAX
package's ``checkpointing/checkpoint.py``, writing its npz layout).

Leaves are keyed by their joined tree path (dict keys, sequence indices,
``|`` between them), so a restore rebuilds the structure without pickling,
and a file written by either package restores in the other.  Writes are
atomic (a temporary file, then a rename), so a killed run never leaves a
torn checkpoint.

numpy has no bf16 or fp8 dtype, so such a leaf is stored as the raw bits
of the same-width unsigned int (bf16 as uint16, ``float8_e4m3fn`` and
``float8_e5m2`` as uint8), as the reference stores its ml_dtypes, and read
back by viewing those bits as the target dtype.  The paged client store's
spill tier (``federated/fleet/paged_store.py``) serialises its pages the
same way.  Every dtype round-trips bit for bit.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_SEP = "|"

# torch dtypes numpy lacks -> (the torch int of the same width that numpy
# takes, the unsigned numpy dtype the bits are stored as)
_BIT_VIEW = {
    torch.bfloat16: (torch.int16, np.uint16),
    torch.float8_e4m3fn: (torch.int8, np.uint8),
    torch.float8_e5m2: (torch.int8, np.uint8),
}


def storage_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype a tensor of ``dtype`` is serialised as."""
    if dtype in _BIT_VIEW:
        return np.dtype(_BIT_VIEW[dtype][1])
    return torch.empty((), dtype=dtype).numpy().dtype


def storage_view(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as a host numpy array of its storage dtype (a copy
    to the host for a device tensor, else no copy)."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    if t.dtype in _BIT_VIEW:
        signed, unsigned = _BIT_VIEW[t.dtype]
        return t.view(signed).numpy().view(unsigned)
    return t.numpy()


def from_storage_view(arr: np.ndarray, dtype: torch.dtype,
                      device=None) -> torch.Tensor:
    """Invert ``storage_view``: stored bits back to a ``dtype`` tensor on
    ``device`` (the CPU by default)."""
    arr = np.ascontiguousarray(arr)
    if dtype in _BIT_VIEW:
        signed = _BIT_VIEW[dtype][0]
        t = torch.from_numpy(arr.view(torch.empty((), dtype=signed)
                                      .numpy().dtype)).view(dtype)
    else:
        t = torch.from_numpy(arr)
        if t.dtype != dtype:
            raise ValueError(f"stored {t.dtype} cannot restore a {dtype} "
                             f"leaf")
    return t.to(device) if device is not None else t


def _flatten_with_path(tree, path=()) -> List[Tuple[str, Any]]:
    """(path key, leaf) in the reference's key format: dict keys and
    sequence indices joined by ``|``."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _flatten_with_path(v, path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_path(v, path + (str(i),))]
    return [(_SEP.join(path), tree)]


def _unflatten(like, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    return build(like)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: storage_view(leaf) for key, leaf in _flatten_with_path(tree)}


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **_flatten(tree))
    except BaseException:
        # a crashed save must not strand a partial tmp file next to the
        # real checkpoints
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, path)
    return path


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf takes its like's
    dtype and device, and its shape is checked."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        flat_like = _flatten_with_path(like)
        keys = {key for key, _ in flat_like}
        missing = keys - set(data.files)
        extra = set(data.files) - keys
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: "
                             f"missing={sorted(missing)[:3]} "
                             f"extra={sorted(extra)[:3]}")
        restored = []
        for key, leaf in flat_like:
            t = from_storage_view(data[key], leaf.dtype, leaf.device)
            if tuple(t.shape) != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{tuple(t.shape)} vs {tuple(leaf.shape)}")
            restored.append(t)
    return _unflatten(like, restored)
