"""The federated-learning configuration, a copy of the JAX package's
``FedConfig`` (``configs/base.py:205-294``) with every field, so configs
are built the same way for both packages.

The port's first slice supports a subset of these fields;
``repro_torch.federated.protocol.RoundProtocol`` raises
``NotImplementedError`` on the rest.  ``use_pallas`` is kept for parity
only: on a CUDA tensor the port always runs its kernels.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class FedConfig:
    strategy: str = "fedadc"       # fedadc|fedadc_double|slowmo|fedavg|fedprox|
                                   # feddyn|scaffold|moon|fedgkd|fedntd|fedrs
    variant: str = "nesterov"      # fedadc: nesterov (red) | heavyball (blue)
    local_steps: int = 8           # H
    clients_per_round: int = 8     # |S_t|
    n_clients: int = 100           # N
    participation: float = 0.2     # c  (used by samplers)
    eta: float = 0.05              # local lr
    alpha: float = 1.0             # server lr multiplier
    beta_global: float = 0.8       # SlowMo / FedADC global momentum
    beta_local: float = 0.8        # FedADC embedding discount
    phi: float = 0.9               # double-momentum local EMA
    mu_prox: float = 0.01          # FedProx proximal coefficient
    feddyn_alpha: float = 0.01     # FedDyn regularization
    # self knowledge distillation (FedADC+)
    distill: bool = False
    distill_lambda: float = 0.35
    distill_tau: float = 1.0
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    use_pallas: bool = False       # kept for config parity; no effect here
    # server-side aggregation: uniform | examples | drag
    aggregator: str = "uniform"
    drag_lambda: float = 4.0       # DRAG divergence temperature
    # semi-async engine
    buffer_k: int = 0              # server update after K deltas; 0 =>
                                   # clients_per_round (synchronous barrier)
    staleness_mode: str = "poly"   # none | poly ((1+s)^-a) | exp (a^s)
    staleness_factor: float = 0.5  # `a` in the discount above
    # uplink delta compression: none bypasses the codec entirely; identity
    # goes through it losslessly; topk/qsgd are lossy with per-client EF
    compressor: str = "none"       # none | identity | topk | qsgd
    topk_frac: float = 0.1         # fraction of entries kept per leaf
    qsgd_bits: int = 8             # magnitude bits (sign sent separately)
    error_feedback: bool = True    # re-inject round-t residual at t+1
    # sparse (value, index) top-k wire, and sparse-native aggregation of it
    sparse_uplink: bool = False
    sparse_aggregate: bool = True
    # downlink broadcast compression
    downlink_compressor: str = "none"   # none | identity | topk | qsgd |
                                        # delta[+identity|+topk|+qsgd]
    downlink_topk_frac: Optional[float] = None
    downlink_qsgd_bits: Optional[int] = None
    # per-client unicast downlink
    downlink_unicast: bool = False
    resync_horizon: int = 4
    # two-tier fleet topology: 0 = flat aggregation, R >= 1 = hierarchical
    fleet_regions: int = 0
