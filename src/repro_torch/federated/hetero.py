"""Client system heterogeneity (counterpart of the JAX package's
``federated/hetero.py``, pure numpy like it).

Real fleets are not the synchronous, identically fast population the
paper's experiments assume: clients differ in compute speed (stragglers),
come and go (availability), and run variable amounts of local work H_i.
This module samples that fleet once per federation from ``HeteroConfig``
and gives the engines the two pieces of algebra they need under it:

* FedNova normalisation (``fednova_scale``): a client that ran H_i local
  steps produced a delta whose magnitude scales with H_i; rescaling by
  H_ref/H_i removes the bias towards fast or verbose clients;
* staleness discounting (``staleness_discount``): in the semi-async engine a
  delta computed against version v applies at version v+s, and its share of
  the FedADC momentum is damped by a factor that decays with s.

All randomness is drawn from one ``RandomState(hetero.seed)`` in event
order, so the virtual-clock scheduler on top is deterministic, and every
draw is the reference's bit for bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import HeteroConfig


def sample_speeds(hetero: HeteroConfig, n_clients: int,
                  rng: np.random.RandomState) -> np.ndarray:
    """Per-client relative compute speed (1.0 = reference client)."""
    if not hetero.enabled or hetero.speed_dist == "constant":
        return np.ones(n_clients, np.float64)
    if hetero.speed_dist == "lognormal":
        s = np.exp(hetero.speed_sigma * rng.randn(n_clients))
        return s / s.max()                      # fastest client = 1.0
    if hetero.speed_dist == "uniform":
        lo, hi = hetero.speed_range
        return rng.uniform(lo, hi, size=n_clients)
    if hetero.speed_dist == "bimodal":
        slow = rng.rand(n_clients) < hetero.straggler_frac
        return np.where(slow, 1.0 / hetero.straggler_slowdown, 1.0)
    raise ValueError(f"unknown speed_dist {hetero.speed_dist!r}")


def sample_local_steps(hetero: HeteroConfig, n_clients: int, base_h: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """Per-client local work H_i (fixed for the federation's lifetime)."""
    if not hetero.enabled or not hetero.local_steps_choices:
        return np.full(n_clients, base_h, np.int64)
    choices = np.asarray(hetero.local_steps_choices, np.int64)
    return choices[rng.randint(0, len(choices), size=n_clients)]


def fednova_scale(h_i, h_ref) -> float:
    """Delta rescale for a client that ran h_i local steps (reference h_ref).

    For plain local SGD the FedNova a_i coefficient is the step count, so the
    normalised delta is Δ_i · (h_ref / h_i)."""
    return float(h_ref) / float(h_i)


def staleness_discount(s, mode: str = "poly", factor: float = 0.5):
    """Momentum damping for a delta that is `s` server versions stale.

    none: 1;  poly: (1+s)^(−factor);  exp: factor^s.  s may be a numpy
    array; the return broadcasts."""
    s = np.asarray(s, np.float64)
    if mode == "none":
        return np.ones_like(s)
    if mode == "poly":
        return (1.0 + s) ** (-factor)
    if mode == "exp":
        return np.asarray(factor, np.float64) ** s
    raise ValueError(f"unknown staleness_mode {mode!r}")


class ClientSystemModel:
    """The fleet: speeds, per-client H_i, availability and dropout draws.

    Speed and H_i are sampled once at construction; availability/dropout/
    jitter are drawn from the same RandomState in event order, which makes a
    fixed-seed simulation bit-reproducible (tested)."""

    def __init__(self, hetero: HeteroConfig, n_clients: int,
                 base_local_steps: int):
        self.hetero = hetero
        self.n_clients = n_clients
        self.base_local_steps = base_local_steps
        rng = np.random.RandomState(hetero.seed)
        self.speeds = sample_speeds(hetero, n_clients, rng)
        self.local_steps = sample_local_steps(hetero, n_clients,
                                              base_local_steps, rng)
        self._rng = rng

    def round_time(self, client: int) -> float:
        """Virtual time for one full local round on `client` (H_i / speed,
        one unit = one local step on the reference client)."""
        base = float(self.local_steps[client]) / float(self.speeds[client])
        if self.hetero.enabled and self.hetero.time_jitter > 0:
            base *= 1.0 + self.hetero.time_jitter * abs(self._rng.randn())
        return base

    def is_available(self, client: int) -> bool:
        if not self.hetero.enabled or self.hetero.availability >= 1.0:
            return True
        return bool(self._rng.rand() < self.hetero.availability)

    def drops_out(self, client: int) -> bool:
        if not self.hetero.enabled or self.hetero.drop_prob <= 0.0:
            return False
        return bool(self._rng.rand() < self.hetero.drop_prob)

    def delta_scale(self, client: int) -> float:
        """FedNova normalisation factor for this client's delta."""
        if not (self.hetero.enabled and self.hetero.fednova):
            return 1.0
        return fednova_scale(self.local_steps[client], self.base_local_steps)
