"""PyTorch + CUDA port of the FedADC reproduction.

A second package beside the JAX reference (``repro``), with the same module
layout.  It imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no card is present.
"""
