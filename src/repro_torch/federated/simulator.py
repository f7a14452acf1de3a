"""Paper-scale federated simulator (counterpart of the JAX package's
``federated/simulator.py``).

Reproduces the paper's experimental setup: N clients with non-iid
partitions, cN sampled per round, H local SGD steps, then the strategy's
server update.  The local objective is the strategy's: cross-entropy, the
FedADC+ self-confidence KD (``distill=True``), or the FedGKD, FedNTD, FedRS
and MOON losses.  The engine drives the round protocol: per-client
cross-round state (SCAFFOLD/FedDyn control variates, MOON's previous local
model) and the uplink's error-feedback residuals live in the protocol's
``ClientStore``, both wire directions go through its ``Transport``, and the
downlink reference through its ``ReferenceStore``.

Where the reference vmaps one client's update over the round's K clients
and scans the H steps, this engine keeps the K clients' parameters stacked
on a leading axis of every leaf, takes the per-client gradients with
``torch.func.vmap(torch.func.grad_and_value(loss))``, and runs the H steps
as a Python loop.  The update kernels then launch once per leaf on the
stacked tensor, outside the vmap; the KD kernels launch inside it, once per
step for all K clients, through their vmap rules.  A round is two halves:
the clients' (``_client_half``: the local steps and the uplink) and the
server's (``_server_half``: weights, aggregate, server step); the
semi-async engine calls each on its own, once per dispatch group and once
per flush.  A ``fleet.FleetScheduler`` given as ``scheduler=`` picks each
round's cohort region-major in place of the selector.

Client picks and batches come from one ``np.random.RandomState(seed)``
consumed in the reference's order (the selector call, then one permutation
per pick and per rep), so the two engines see the same data.  The
reference's JAX-keyed init cannot be reproduced in torch: pass converted
reference parameters as ``params=`` to start both from the same point.
Likewise QSGD's uniform draws: they come from ``uniforms=``, a source
``(name, shape, dtype, device) -> tensor`` asked once per leaf with
``name = (round, "uplink" | "downlink", ..., leaf path)``; by default one
``torch.Generator`` on the device seeded from ``seed ^ 0x5F5E1``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core import distillation as D
from repro_torch.core import tree as T
from repro_torch.core.selection import SELECTORS
from repro_torch.core.strategies import get_strategy
from repro_torch.data.partition import class_counts
from repro_torch.device import resolve_device
from repro_torch.federated import aggregation as A
from repro_torch.federated.compression import GeneratorUniforms, UniformDraws
from repro_torch.federated.protocol import RoundProtocol
from repro_torch.models.vision import VISION_MODELS
from repro_torch.telemetry import Telemetry, round_metrics


@dataclass
class SimConfig:
    model: str = "cnn"
    n_classes: int = 10
    batch_size: int = 64
    rounds: int = 100
    eval_every: int = 5
    eval_batch: int = 512
    selector: str = "random"
    moon_mu: float = 1.0
    moon_temp: float = 0.5
    fedrs_alpha: float = 0.5
    fedgkd_lambda: float = 0.1
    fedgkd_tau: float = 0.5
    fedntd_beta: float = 0.3
    fedntd_tau: float = 1.0
    seed: int = 0
    cnn_width: int = 32


class FederatedSimulator:
    _engine_name = "sim"

    def __init__(self, fed: FedConfig, sim: SimConfig,
                 x_train, y_train, x_test, y_test,
                 parts: List[np.ndarray],
                 telemetry: Optional[Telemetry] = None,
                 store=None, params=None, device=None, uniforms=None,
                 scheduler=None):
        self.device = resolve_device(device)
        self.fed, self.sim = fed, sim
        # a fleet.FleetScheduler replaces the flat selector with
        # region-major cohorts (an engine argument, like the store)
        self.scheduler = scheduler
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry.disabled(self._engine_name)
        self.strategy = get_strategy(fed.strategy)
        self.protocol = RoundProtocol(fed, strategy=self.strategy,
                                      store=store, telemetry=self.telemetry)
        self.transport = self.protocol.transport
        self.refs = self.protocol.refs
        # the training set stays on the host (each round ships its
        # batches); the test set moves to the device once
        self.x_train, self.y_train = x_train, y_train
        self.x_test = torch.as_tensor(x_test, device=self.device)
        self.y_test = torch.as_tensor(y_test, device=self.device).long()
        self.parts = parts
        self.n_clients = len(parts)
        self.rng = np.random.RandomState(sim.seed)
        self.counts = class_counts(y_train, parts, sim.n_classes)

        init, self.apply, self.features = VISION_MODELS[sim.model][:3]
        if params is None:
            if sim.model == "cnn":
                params = init(sim.seed, n_classes=sim.n_classes,
                              width=sim.cnn_width,
                              image_size=x_train.shape[1], device=self.device)
            else:
                params = init(sim.seed, n_classes=sim.n_classes,
                              device=self.device)
        else:
            params = T.tree_map(lambda t: t.to(self.device), params)
        self.params = params
        self.server_state = self.strategy.server_init(self.params)
        # MOON keeps each client's previous local model
        self.stateful = not self.strategy.stateless_clients \
            or fed.strategy == "moon"
        self.protocol.register_client_state(self._client_state_init)
        self.ef_enabled = self.protocol.ef_enabled
        self.protocol.register_ef(self._ef_init)
        self.uniforms = uniforms if uniforms is not None \
            else GeneratorUniforms(sim.seed ^ 0x5F5E1, self.device)
        ctx = self.strategy.client_setup(self.server_state, self.params, fed)
        self.transport.set_wire_templates(
            self.params, {"params": self.params, "ctx": ctx})
        # the delta downlink's round-0 reference is the initial sync, so the
        # first wire delta is exactly zero (held only for the lossy family)
        self.refs.seed(self.protocol.init_downlink_ref(self.server_state,
                                                       self.params))
        self._rounds_done = 0

    @property
    def history(self) -> Sequence[Dict]:
        return self.telemetry.history

    @property
    def client_states(self) -> Dict[int, object]:
        return self.protocol.store.states("state")

    @property
    def ef_states(self) -> Dict[int, object]:
        return self.protocol.store.states("ef")

    @property
    def uplink_bytes(self) -> int:
        return self.transport.uplink_bytes

    @property
    def uplink_bytes_raw(self) -> int:
        return self.transport.uplink_bytes_raw

    @property
    def downlink_bytes(self) -> int:
        return self.transport.downlink_bytes

    @property
    def downlink_bytes_raw(self) -> int:
        return self.transport.downlink_bytes_raw

    # ------------------------------------------------------------------
    @property
    def _lossy_uplink(self) -> bool:
        up = self.transport.up
        return up is not None and up.lossy

    @property
    def _lossy_downlink(self) -> bool:
        down = self.transport.down
        return down is not None and down.lossy

    def _client_state_init(self):
        if self.fed.strategy == "moon":
            return {"prev": self.params}
        return self.strategy.client_state_init(self.params)

    def _ef_init(self):
        if self._lossy_uplink:
            return T.zeros_like(self.params)
        # codec bypassed or lossless: the same placeholder as the reference
        return {"_": torch.zeros((), device=self.device)}

    def _local_loss(self, theta, xb, yb, theta_t, counts, cstate):
        """One client's local objective (Sec. III / IV-A); ``theta_t`` is
        the broadcast model (the teacher), ``counts`` the client's class
        counts (C,), ``cstate`` its cross-round state."""
        fed, sim = self.fed, self.sim
        name = fed.strategy
        logits = self.apply(theta, xb)
        if fed.distill:   # FedADC+ self-confidence KD (eqs. 7-9)
            t_logits = self.apply(theta_t, xb).detach()
            loss, _ = D.self_confidence_kd_loss(
                logits, t_logits, yb, counts, fed.distill_lambda,
                fed.distill_tau)
            return loss
        if name == "fedgkd":
            t_logits = self.apply(theta_t, xb).detach()
            return D.fedgkd_loss(logits, t_logits, yb, sim.fedgkd_lambda,
                                 sim.fedgkd_tau)[0]
        if name == "fedntd":
            t_logits = self.apply(theta_t, xb).detach()
            return D.fedntd_loss(logits, t_logits, yb, sim.fedntd_beta,
                                 sim.fedntd_tau)[0]
        if name == "fedrs":
            present = (counts > 0).float()
            return D.cross_entropy(D.fedrs_logits(logits, present,
                                                  sim.fedrs_alpha), yb)
        if name == "moon":
            z = self.features(theta, xb)
            z_g = self.features(theta_t, xb).detach()
            z_p = self.features(cstate["prev"], xb).detach()
            return D.cross_entropy(logits, yb) + D.moon_loss(
                z, z_g, z_p, sim.moon_mu, sim.moon_temp)
        return D.cross_entropy(logits, yb)

    def _client_update(self, theta_t, ctx, xb, yb, counts, cstates):
        """The round's K clients at once.  xb (K,H,b,...), yb (K,H,b),
        counts (K,C) -> (client-stacked deltas, new client states, the
        (H, K) step losses, θ_H)."""
        strategy, fed = self.strategy, self.fed
        k, h_steps = xb.shape[:2]

        def stack(t):
            return t.expand((k,) + t.shape).contiguous()
        theta = T.tree_map(stack, theta_t)
        ctx_k = T.tree_map(stack, ctx)
        # stateful-client strategies (SCAFFOLD c_i, FedDyn h_i) carry
        # their cross-round state through the local-step `extra` slot
        if hasattr(strategy, "client_state_init"):
            extra = cstates
        else:
            extra = strategy.init_extra(theta, fed)
        # θ, the batch, the counts and the client state per client; the
        # broadcast θ_t (the teacher) shared
        grad = torch.func.vmap(
            torch.func.grad_and_value(self._local_loss),
            in_dims=(0, 0, 0, None, 0, None if cstates is None else 0))
        losses = []
        for h in range(h_steps):
            bx, by = xb[:, h], yb[:, h]

            def grad_fn(th, _batch, bx=bx, by=by):
                g, val = grad(th, bx, by, theta_t, counts, cstates)
                # the update kernels take contiguous operands
                return T.tree_map(lambda x: x.contiguous(), g), val
            theta, extra, val = strategy.local_step(theta, ctx_k, grad_fn,
                                                    None, fed, extra)
            losses.append(val)
        delta = T.sub(theta_t, theta)
        new_cstates = cstates
        if hasattr(strategy, "client_state_update"):
            new_cstates = strategy.client_state_update(cstates, ctx_k,
                                                       theta_t, theta, fed)
        elif fed.strategy == "moon":
            new_cstates = {"prev": theta}
        return delta, new_cstates, torch.stack(losses), theta

    def _client_half(self, params_w, ctx, xb, yb, counts, cstates, efs,
                     up_key):
        """The clients' half of a round: the local steps from the broadcast
        (params_w, ctx), then the uplink -> (the wire the server aggregates,
        new client states, new EF residuals, the (H, K) step losses, θ_H).
        The async engine calls it once per dispatch group."""
        protocol = self.protocol
        deltas, ncs, losses, theta_hs = self._client_update(
            params_w, ctx, xb, yb, counts, cstates)
        if protocol.sparse_native:
            # encode only: the (values, indices) wire flows straight into
            # the sparse aggregate, with the same exact-complement EF
            deltas, new_efs = protocol.uplink_encode(deltas, efs, up_key)
        else:
            deltas, new_efs = protocol.uplink(deltas, efs, up_key)
        return deltas, ncs, new_efs, losses, theta_hs

    def _aggregate(self, deltas, n_examples):
        """Δ̄ of the stacked wire under the configured weights."""
        protocol = self.protocol
        weights = protocol.weights(deltas, n_examples=n_examples,
                                   server_state=self.server_state,
                                   like=self.params)
        return protocol.aggregate(deltas, weights, like=self.params)

    def _drift(self, deltas, mean_delta, efs=None):
        """The round's drift diagnostics (``telemetry.round_metrics``) over
        the deltas the server aggregates, against their Δ̄, with the
        momentum broadcast this round (read before the server step) and,
        when EF is on, the new residuals."""
        return round_metrics(
            deltas, mean_delta,
            momentum=A.reference_direction(self.server_state),
            efs=efs if self.ef_enabled else None)

    def _server_half(self, deltas, n_examples, drift=None, efs=None):
        """The server's half of a round for the stateless-server
        strategies: weights, aggregate and the strategy's server step ->
        (params', server_state').  The async engine calls it once per
        flush.  Given a dict as ``drift`` (telemetry on), it also fills it
        with the round's drift diagnostics (``efs``: the new EF
        residuals)."""
        mean_delta = self._aggregate(deltas, n_examples)
        if drift is not None:
            drift.update(self._drift(deltas, mean_delta, efs))
        return self.protocol.server_update(self.server_state, self.params,
                                           mean_delta)

    def _round(self, xb, yb, counts, cstates, n_examples, efs, keys, bcast):
        """One round's device work: both halves -> (params', server_state',
        client states, EF residuals, mean loss, drift), the drift dict None
        with telemetry off.  ``keys`` = (uplink, downlink) draws;
        ``bcast`` is the (params_w, ctx) wire of the delta family computed
        through the ReferenceStore, or None to broadcast inline."""
        strategy, fed, protocol = self.strategy, self.fed, self.protocol
        drift = {} if self.telemetry.enabled else None
        up_key, down_key = keys
        if bcast is None:
            params_w, ctx, _ = protocol.client_ctx(
                self.server_state, self.params,
                down_key if self._lossy_downlink else None, None)
        else:
            params_w, ctx = bcast
        deltas, ncs, new_efs, losses, theta_hs = self._client_half(
            params_w, ctx, xb, yb, counts, cstates, efs, up_key)
        if fed.strategy == "feddyn":
            # FedDyn's server step reads no Δ̄ (the reference's jit drops
            # the unused aggregate; here it is computed only for the drift
            # diagnostics)
            if drift is not None:
                drift.update(self._drift(
                    deltas, self._aggregate(deltas, n_examples), new_efs))
            mean_theta_h = T.tree_map(lambda d: torch.mean(d, 0), theta_hs)
            sum_drift = T.tree_map(
                lambda d: -torch.sum(d, 0) / self.n_clients, deltas)
            new_params, new_ss = strategy.server_update_feddyn(
                self.server_state, self.params, mean_theta_h, sum_drift, fed)
        elif fed.strategy == "scaffold":
            mean_delta = self._aggregate(deltas, n_examples)
            if drift is not None:
                drift.update(self._drift(deltas, mean_delta, new_efs))
            dcs = T.sub(ncs, cstates)
            mean_dc = T.tree_map(lambda d: torch.mean(d, 0), dcs)["c_i"]
            part_frac = xb.shape[0] / self.n_clients
            new_params, new_ss = strategy.server_update_scaffold(
                self.server_state, self.params, mean_delta, mean_dc, fed,
                part_frac)
        else:
            new_params, new_ss = self._server_half(deltas, n_examples, drift,
                                                   new_efs)
        return new_params, new_ss, ncs, new_efs, losses.mean(), drift

    # ------------------------------------------------------------------
    def _client_batches(self, client: int, local_steps: Optional[int] = None):
        fed, sim = self.fed, self.sim
        h = fed.local_steps if local_steps is None else local_steps
        idx = self.parts[client]
        need = h * sim.batch_size
        reps = max(int(np.ceil(need / len(idx))), 1)
        pool = np.concatenate([self.rng.permutation(idx) for _ in range(reps)])
        sel = pool[:need].reshape(h, sim.batch_size)
        return self.x_train[sel], self.y_train[sel]

    @torch.no_grad()
    def evaluate(self) -> float:
        n = len(self.x_test)
        b = self.sim.eval_batch
        # device-resident partial sums; one host fetch at the end
        correct = sum(
            torch.sum(torch.argmax(self.apply(self.params,
                                              self.x_test[i:i + b]), -1)
                      == self.y_test[i:i + b])
            for i in range(0, n, b))
        return int(correct) / n

    def next_round_inputs(self):
        """Draw the next round's picks and batches from the simulator's
        stream -> (picks, xb, yb) with xb (K,H,b,...) and yb (K,H,b) on the
        device.  ``run`` consumes exactly this."""
        sel = SELECTORS[self.sim.selector]
        if self.scheduler is not None:
            # region-major cohort: pick k of a scheduler cohort lands in the
            # aggregator region that owns it by construction
            picks = self.scheduler.sample_cohort(
                self.fed.clients_per_round).clients
        elif self.sim.selector == "random":
            picks = sel(self.rng, self.n_clients, self.fed.clients_per_round)
        else:
            picks = sel(self.rng, self.n_clients, self.fed.clients_per_round,
                        self.counts)
        xs, ys = zip(*[self._client_batches(int(c)) for c in picks])
        xb = torch.from_numpy(np.stack(xs)).to(self.device)
        yb = torch.from_numpy(np.stack(ys)).to(self.device).long()
        return picks, xb, yb

    def run_round(self, picks, xb, yb):
        """One round on given picks and batches -> the round's mean local
        loss (a device scalar)."""
        t = self._rounds_done
        cstates = (self.protocol.store.gather("state", picks)
                   if self.stateful else None)
        efs = self.protocol.store.gather("ef", picks)
        counts = torch.as_tensor(self.counts[picks], dtype=torch.float32,
                                 device=self.device)
        n_examples = torch.tensor([len(self.parts[int(c)]) for c in picks],
                                  dtype=torch.float32, device=self.device)
        keys = (UniformDraws(self.uniforms, (t, "uplink"), self.device),
                UniformDraws(self.uniforms, (t, "downlink"), self.device))

        def compute_bcast(ref):
            return self.protocol.client_ctx(
                self.server_state, self.params,
                keys[1] if self._lossy_downlink else None, ref)
        bcast = None
        if self.transport.stateful_downlink:
            # lossy delta family: one broadcast per version through the
            # ReferenceStore, which advances the reference exactly once
            bcast = self.refs.broadcast(t, compute_bcast)
        wire = bcast
        if wire is None and self.refs.unicast:
            # the lossless delta stays inline in the round; the unicast
            # layer still takes the wire once per round for the pages
            wire = self.refs.broadcast(t, compute_bcast)
        tel = self.telemetry
        with tel.tracer.span("round") as sp:
            (self.params, self.server_state, ncs, nefs, loss,
             drift) = self._round(xb, yb, counts, cstates, n_examples, efs,
                                  keys, bcast)
            if tel.enabled:
                # the span stops after the round's work on the card, not
                # after the launches
                sp.sync = (self.params, loss)
        if self.stateful:
            self.protocol.store.scatter("state", picks, ncs)
        if self.ef_enabled:
            self.protocol.store.scatter("ef", picks, nefs)
        # downlink accounting and the unicast ledgers (the delta codec's
        # first broadcast is the full initial sync)
        self.refs.dispatch(picks, t, wire=wire)
        self._rounds_done += 1
        self.transport.account_uplink(len(picks))
        if tel.enabled:
            # one device-to-host transfer for the drift scalars and the loss
            names = sorted(drift)     # the reference's key order
            vals = torch.stack([drift[k] for k in names] + [loss]).tolist()
            tel.record_round(t, {**dict(zip(names, vals)), "loss": vals[-1]})
        return loss

    def run(self, rounds: Optional[int] = None, log_fn: Callable = None):
        rounds = self.sim.rounds if rounds is None else rounds
        for t in range(rounds):
            loss = self.run_round(*self.next_round_inputs())
            if (t + 1) % self.sim.eval_every == 0 or t == rounds - 1:
                acc = self.evaluate()
                self.telemetry.record_eval({"round": t + 1, "acc": acc,
                                            "loss": float(loss)})
                if log_fn:
                    log_fn(self.history[-1])
        return self.history
