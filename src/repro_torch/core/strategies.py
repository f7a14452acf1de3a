"""FL strategy algebra — the paper's contribution (FedADC, Alg. 3/4) plus
every baseline it compares against (counterpart of the JAX package's
``core/strategies.py``).

Interface:
  server_init(params)              -> server_state dict
  client_setup(server_state, params, fed) -> ctx broadcast to clients
  init_extra(theta, fed)           -> per-local-step state (or None)
  local_step(theta, ctx, grad_fn, batch, fed, extra) -> (theta', extra', aux)
  server_aggregate(deltas, weights, fed) -> mean_delta
  server_update(server_state, theta_t, mean_delta, fed)
       -> (theta_{t+1}, server_state')

Local steps work on client-stacked trees: every leaf of ``theta``, the
gradient, ``extra`` and ``ctx`` carries the round's K clients on a leading
axis (the simulator expands the broadcast ctx to that shape), where the
reference vmaps one client's step.  On CUDA tensors the updates run the
port's Hopper kernels, launched on the stacked tensors:

* ``_sgd_step`` and the nesterov half-step θ − η·m̄ go through
  ``fused_axpy_tree`` with a = −η (x + (−η)·y equals x − η·y bit for bit
  when the multiply and the add are rounded on their own);
* the heavy-ball step goes through ``fedadc_local_update_tree``, with clip
  and weight decay applied to g before the call;
* the FedADC and SlowMo server steps go through
  ``fedadc_server_update_tree``, which forms Δ̄ = mean_delta/η in fp32 in
  the same pass, keeps m in fp32 and writes θ in the parameter dtype; the
  server aggregate goes through ``weighted_delta_reduce_tree``.

Each is one launch for every leaf of the tree (per dtype, per 64 leaves).

The rest of the tree algebra is plain torch, as the reference leaves it to
XLA.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict

import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import tree as T
from repro_torch.kernels import ops


# hooks that have fired their deprecation warning in this process, by name,
# so a shim warns once, not once per call
_DEPRECATION_WARNED: set = set()


def _warn_deprecated(hook: str, replacement: str) -> None:
    if hook in _DEPRECATION_WARNED:
        return
    _DEPRECATION_WARNED.add(hook)
    warnings.warn(f"{hook} is deprecated; use {replacement} "
                  f"(DESIGN.md §Transport migration table)",
                  DeprecationWarning, stacklevel=3)


def _maybe_clip(g, fed: FedConfig):
    if fed.grad_clip > 0:
        g = T.clip_per_client(g, fed.grad_clip)
    return g


def _wd(theta, g, fed: FedConfig):
    if fed.weight_decay > 0:
        g = T.axpy(fed.weight_decay, theta, g)
    return g


def _sgd_step(theta, g, eta, fed):
    g = _wd(theta, _maybe_clip(g, fed), fed)
    return ops.fused_axpy_tree(theta, g, -eta)


# ---------------------------------------------------------------------------
# FedAvg (Alg. 1)
# ---------------------------------------------------------------------------
class FedAvg:
    name = "fedavg"
    stateless_clients = True

    def server_init(self, params):
        return {}

    def client_setup(self, server_state, params, fed):
        return {}

    def init_extra(self, params, fed):
        return None

    def local_step(self, theta, ctx, grad_fn, batch, fed, extra):
        g, aux = grad_fn(theta, batch)
        return _sgd_step(theta, g, fed.eta, fed), extra, aux

    def compress_delta(self, delta, ef, key, fed):
        """Deprecated: the uplink moved off the strategy into the wire
        layer (``Transport.uplink``, which the engines drive through
        ``RoundProtocol.uplink``).  Warns once per process, then delegates
        to a cached stateless ``Transport`` (``shim_transport``)."""
        _warn_deprecated("strategy.compress_delta",
                         "RoundProtocol.uplink / Transport.uplink")
        from repro_torch.federated.transport import shim_transport  # layering
        return shim_transport(fed).uplink(delta, ef, key)

    def server_aggregate(self, deltas, weights, fed):
        """Δ̄ = Σ_i w_i·Δ_i / Σ_i w_i over client-stacked deltas."""
        from repro_torch.federated.aggregation import weighted_mean  # layering
        return weighted_mean(deltas, weights)

    def server_update(self, server_state, theta_t, mean_delta, fed):
        # θ_{t+1} = mean(θ_i^H) = θ_t - mean_delta
        return T.sub(theta_t, mean_delta), server_state


def _theta_step(theta_t, m, fed):
    """θ_{t+1} = θ_t − α·η·m, computed in fp32 and cast back to the
    parameter dtype (the fp32 momentum must not promote bf16 parameters)."""
    theta = T.axpy(-fed.alpha * fed.eta, m, T.cast(theta_t, torch.float32))
    return T.tree_map(lambda nt, t: nt.to(t.dtype), theta, theta_t)


def _fused_server_step(theta_t, m, mean_delta, gamma, fed):
    """Δ̄ = mean_delta/η in fp32 ; m' = Δ̄ + γ·m ; θ' = θ − αη·m' over every
    leaf in one server-update sweep -> (θ', m')."""
    return ops.fedadc_server_update_tree(theta_t, m, mean_delta, gamma,
                                         fed.alpha * fed.eta,
                                         scale=1.0 / fed.eta)


def _fp32_zeros_like(params):
    # the momentum accumulates Δ̄ across rounds: it is held in fp32
    # regardless of the parameter dtype (a bf16 m loses small late-round
    # pseudo-gradients)
    return T.cast(T.zeros_like(params), torch.float32)


# ---------------------------------------------------------------------------
# SlowMo (Alg. 2) — server momentum over pseudo gradients.
# ---------------------------------------------------------------------------
class SlowMo(FedAvg):
    name = "slowmo"

    def server_init(self, params):
        return {"m": _fp32_zeros_like(params)}

    def server_update(self, server_state, theta_t, mean_delta, fed):
        theta, m = _fused_server_step(theta_t, server_state["m"], mean_delta,
                                      fed.beta_global, fed)  # lines 12-16
        return theta, {"m": m}


# ---------------------------------------------------------------------------
# FedADC (Alg. 3) — THE PAPER'S CONTRIBUTION.
# The global momentum m_t is normalised (m̄_t = β_local · m_t / H) and
# embedded into every local iteration; the server applies the small
# correction (β_global − β_local)·m_t when rebuilding the pseudo momentum.
# ---------------------------------------------------------------------------
class FedADC(FedAvg):
    name = "fedadc"

    def server_init(self, params):
        return {"m": _fp32_zeros_like(params)}

    def client_setup(self, server_state, params, fed):
        # line 5: m̄_t = β_local · m_t / H, broadcast in the params dtype
        m_bar = T.scale(server_state["m"], fed.beta_local / fed.local_steps)
        return {"m_bar": T.tree_map(lambda m, p: m.to(p.dtype), m_bar,
                                    params)}

    # the ctx is an exact scalar image of the θ-delta (server_update:
    # Δθ_t = −α·η·m_t while m̄_t = β_l/H · m_t), so the delta downlink
    # derives it from the θ wire instead of sending it: 0 bytes.
    # `delta_params` is the decoded θ-delta the clients received; the scale
    # comes from the config, never from the wire.
    def _ctx_scale(self, fed):
        return -fed.beta_local / (fed.local_steps * fed.alpha * fed.eta)

    def ctx_from_broadcast_delta(self, delta_params, fed):
        return {"m_bar": T.scale(delta_params, self._ctx_scale(fed))}

    def local_step(self, theta, ctx, grad_fn, batch, fed, extra):
        m_bar = ctx["m_bar"]
        if fed.variant == "nesterov":
            # red: θ^{τ-1/2} = θ − η·m̄ ; g at θ^{τ-1/2}; θ = θ^{τ-1/2} − η·g
            theta_half = ops.fused_axpy_tree(theta, m_bar, -fed.eta)
            g, aux = grad_fn(theta_half, batch)
            theta_new = _sgd_step(theta_half, g, fed.eta, fed)
        else:
            # blue (heavy-ball): θ = θ − η·(g + m̄), with clip and weight
            # decay folded into g before the fused step
            g, aux = grad_fn(theta, batch)
            g = _wd(theta, _maybe_clip(g, fed), fed)
            theta_new = ops.fedadc_local_update_tree(theta, g, m_bar,
                                                     fed.eta)
        return theta_new, extra, aux

    def server_update(self, server_state, theta_t, mean_delta, fed):
        theta, m = _fused_server_step(theta_t, server_state["m"], mean_delta,
                                      fed.beta_global - fed.beta_local,
                                      fed)                  # lines 16-19
        return theta, {"m": m}


# ---------------------------------------------------------------------------
# FedADC with double momentum (Alg. 4).
# ---------------------------------------------------------------------------
class FedADCDouble(FedADC):
    name = "fedadc_double"

    def client_setup(self, server_state, params, fed):
        m_bar = T.scale(server_state["m"], fed.beta_global / fed.local_steps)
        return {"m_bar": T.tree_map(lambda m, p: m.to(p.dtype), m_bar,
                                    params)}

    def _ctx_scale(self, fed):
        # Alg. 4 broadcasts m̄_t = β_g/H · m_t against the same Δθ = −αη·m_t
        return -fed.beta_global / (fed.local_steps * fed.alpha * fed.eta)

    def init_extra(self, params, fed):
        return {"m_local": T.zeros_like(params), "tau": 0}

    def local_step(self, theta, ctx, grad_fn, batch, fed, extra):
        g, aux = grad_fn(theta, batch)
        g = _maybe_clip(g, fed)
        if extra["tau"] == 0:                                # lines 9-12
            m_local = g
        else:
            m_local = T.tree_map(lambda ml, gi: fed.phi * ml
                                 + (1 - fed.phi) * gi, extra["m_local"], g)
        upd = T.add(ctx["m_bar"], m_local)                   # line 14
        theta_new = T.tree_map(lambda t, u: t - fed.eta * u, theta,
                               _wd(theta, upd, fed))
        return theta_new, {"m_local": m_local, "tau": extra["tau"] + 1}, aux

    def server_update(self, server_state, theta_t, mean_delta, fed):
        m = T.scale(T.cast(mean_delta, torch.float32),
                    1.0 / fed.eta)                           # line 21 (no carry)
        theta = _theta_step(theta_t, m, fed)                 # line 23
        return theta, {"m": m}


# ---------------------------------------------------------------------------
# FedProx — proximal term μ/2‖θ − θ_t‖² added to the local objective.
# ---------------------------------------------------------------------------
class FedProx(FedAvg):
    name = "fedprox"

    def client_setup(self, server_state, params, fed):
        return {"theta_t": params}

    def local_step(self, theta, ctx, grad_fn, batch, fed, extra):
        g, aux = grad_fn(theta, batch)
        g = T.add(g, T.scale(T.sub(theta, ctx["theta_t"]), fed.mu_prox))
        return _sgd_step(theta, g, fed.eta, fed), extra, aux


# ---------------------------------------------------------------------------
# SCAFFOLD — control variates (stateful clients; simulator only).
# ---------------------------------------------------------------------------
class Scaffold(FedAvg):
    name = "scaffold"
    stateless_clients = False

    def server_init(self, params):
        return {"c": T.zeros_like(params)}

    def client_state_init(self, params):
        return {"c_i": T.zeros_like(params)}

    def client_setup(self, server_state, params, fed):
        return {"c": server_state["c"]}

    def local_step(self, theta, ctx, grad_fn, batch, fed, extra):
        g, aux = grad_fn(theta, batch)
        g = T.add(T.sub(g, extra["c_i"]), ctx["c"])
        return _sgd_step(theta, g, fed.eta, fed), extra, aux

    def client_state_update(self, client_state, ctx, theta_t, theta_H, fed):
        # option II: c_i' = c_i − c + (θ_t − θ_H)/(H·η)
        c_new = T.add(T.sub(client_state["c_i"], ctx["c"]),
                      T.scale(T.sub(theta_t, theta_H),
                              1.0 / (fed.local_steps * fed.eta)))
        return {"c_i": c_new}

    def server_update_scaffold(self, server_state, theta_t, mean_delta,
                               mean_dc, fed, part_frac):
        theta = T.sub(theta_t, mean_delta)
        c = T.add(server_state["c"], T.scale(mean_dc, part_frac))
        return theta, {"c": c}


# ---------------------------------------------------------------------------
# FedDyn — dynamic regularisation (stateful clients; simulator only).
# ---------------------------------------------------------------------------
class FedDyn(FedAvg):
    name = "feddyn"
    stateless_clients = False

    def server_init(self, params):
        return {"h": T.zeros_like(params)}

    def client_state_init(self, params):
        return {"grad_corr": T.zeros_like(params)}

    def client_setup(self, server_state, params, fed):
        return {"theta_t": params}

    def local_step(self, theta, ctx, grad_fn, batch, fed, extra):
        g, aux = grad_fn(theta, batch)
        # ∇ [ f_i(θ) − <∇̂_i, θ> + α/2 ‖θ − θ_t‖² ]
        g = T.sub(g, extra["grad_corr"])
        g = T.add(g, T.scale(T.sub(theta, ctx["theta_t"]), fed.feddyn_alpha))
        return _sgd_step(theta, g, fed.eta, fed), extra, aux

    def client_state_update(self, client_state, ctx, theta_t, theta_H, fed):
        gc = T.sub(client_state["grad_corr"],
                   T.scale(T.sub(theta_H, theta_t), fed.feddyn_alpha))
        return {"grad_corr": gc}

    def server_update_feddyn(self, server_state, theta_t, mean_theta_H,
                             mean_drift_all, fed):
        # h ← h − α · (1/N) Σ_i (θ_i^H − θ_t);  θ ← mean(θ^H) − h/α
        h = T.sub(server_state["h"], T.scale(mean_drift_all, fed.feddyn_alpha))
        theta = T.sub(mean_theta_H, T.scale(h, 1.0 / fed.feddyn_alpha))
        return theta, {"h": h}


STRATEGIES: Dict[str, Any] = {
    s.name: s for s in
    (FedAvg(), SlowMo(), FedADC(), FedADCDouble(), FedProx(), Scaffold(),
     FedDyn())
}
# loss-modifier strategies reuse FedAvg's update algebra; their local losses
# are the simulator's (``FederatedSimulator._local_loss``)
for alias in ("moon", "fedgkd", "fedntd", "fedrs"):
    STRATEGIES[alias] = FedAvg()


def get_strategy(name: str):
    if name == "fedadc+":
        return STRATEGIES["fedadc"]
    if name not in STRATEGIES:
        raise KeyError(f"unknown strategy {name!r}; known {sorted(STRATEGIES)}")
    return STRATEGIES[name]
