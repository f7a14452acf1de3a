"""Mesh shapes (counterpart of the JAX package's ``launch/mesh.py``).

The reference builds ``jax`` meshes of TPU chips.  The port runs on one
card, so a mesh here is a ``MeshShape``: axis names and sizes to plan and
count against (``sharding/specs.py``, ``launch/dryrun.py``).  Nothing is
allocated and no collective is built.
"""
from __future__ import annotations

from repro_torch.sharding.specs import MeshShape


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 chips per pod (the reference's TPU v5e pod slice); the
    multi-pod mesh adds a leading "pod" axis of 2 (512 chips)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh() -> MeshShape:
    """The reference's single-device mesh for CPU smoke tests (1×1, same
    axis names)."""
    return MeshShape(("data", "model"), (1, 1))


def make_card_mesh() -> MeshShape:
    """The one card the port runs on: (1, 1) with the same axis names.
    The only mesh anything in the port runs on."""
    return MeshShape(("data", "model"), (1, 1))
