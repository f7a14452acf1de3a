"""Paper-scale federated simulator (counterpart of the JAX package's
``federated/simulator.py``).

Reproduces the paper's experimental setup: N clients with non-iid
partitions, cN sampled per round, H local SGD steps, then the strategy's
server update.  The engine drives the round protocol: per-client
cross-round state (SCAFFOLD/FedDyn) lives in the protocol's
``ClientStore``, and both wire directions go through its ``Transport``.

Where the reference vmaps one client's update over the round's K clients
and scans the H steps, this engine keeps the K clients' parameters stacked
on a leading axis of every leaf, takes the per-client gradients with
``torch.func.vmap(torch.func.grad_and_value(loss))``, and runs the H steps
as a Python loop.  The update kernels then launch once per leaf on the
stacked tensor, outside the vmap.

Client picks and batches come from one ``np.random.RandomState(seed)``
consumed in the reference's order (the selector call, then one permutation
per pick and per rep), so the two engines see the same data.  The
reference's JAX-keyed init cannot be reproduced in torch: pass converted
reference parameters as ``params=`` to start both from the same point.
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
from repro_torch.federated.protocol import RoundProtocol
from repro_torch.models.vision import VISION_MODELS
from repro_torch.telemetry import Telemetry


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
                 store=None, params=None, device=None):
        self.device = resolve_device(device)
        self.fed, self.sim = fed, sim
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry.disabled(self._engine_name)
        self.strategy = get_strategy(fed.strategy)
        # composing the protocol first rejects configs outside this slice
        # before any data moves
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

        init, self.apply = VISION_MODELS[sim.model][:2]
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
        self.stateful = not self.strategy.stateless_clients
        self.protocol.register_client_state(self._client_state_init)
        # EF residuals exist only behind a lossy codec (the wire slice); the
        # namespace is registered so the store layout matches the reference
        self.protocol.register_ef(lambda: T.zeros_like(self.params))
        ctx = self.strategy.client_setup(self.server_state, self.params, fed)
        self.transport.set_wire_templates(
            self.params, {"params": self.params, "ctx": ctx})
        self._rounds_done = 0
        self._grad = torch.func.vmap(torch.func.grad_and_value(
            self._local_loss))

    @property
    def history(self) -> Sequence[Dict]:
        return self.telemetry.history

    @property
    def client_states(self) -> Dict[int, object]:
        return self.protocol.store.states("state")

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
    def _client_state_init(self):
        return self.strategy.client_state_init(self.params)

    def _local_loss(self, theta, xb, yb):
        """One client's local objective (the plain cross-entropy in this
        slice; RoundProtocol rejects the loss-modifier strategies)."""
        return D.cross_entropy(self.apply(theta, xb), yb)

    def _client_update(self, theta_t, ctx, xb, yb, cstates):
        """The round's K clients at once.  xb (K,H,b,...), yb (K,H,b) ->
        (client-stacked deltas, new client states, mean loss, θ_H)."""
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
        losses = []
        for h in range(h_steps):
            bx, by = xb[:, h], yb[:, h]

            def grad_fn(th, _batch, bx=bx, by=by):
                g, val = self._grad(th, bx, by)
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
        return delta, new_cstates, torch.stack(losses).mean(), theta

    def _round(self, xb, yb, cstates, n_examples):
        strategy, fed, protocol = self.strategy, self.fed, self.protocol
        params_w, ctx = protocol.client_ctx(self.server_state, self.params)
        deltas, ncs, loss, theta_hs = self._client_update(params_w, ctx, xb,
                                                          yb, cstates)
        deltas, _ = protocol.uplink(deltas)
        weights = protocol.weights(deltas, n_examples=n_examples,
                                   server_state=self.server_state)
        mean_delta = protocol.aggregate(deltas, weights)
        if fed.strategy == "feddyn":
            mean_theta_h = T.tree_map(lambda d: torch.mean(d, 0), theta_hs)
            sum_drift = T.tree_map(
                lambda d: -torch.sum(d, 0) / self.n_clients, deltas)
            new_params, new_ss = strategy.server_update_feddyn(
                self.server_state, self.params, mean_theta_h, sum_drift, fed)
        elif fed.strategy == "scaffold":
            dcs = T.sub(ncs, cstates)
            mean_dc = T.tree_map(lambda d: torch.mean(d, 0), dcs)["c_i"]
            part_frac = xb.shape[0] / self.n_clients
            new_params, new_ss = strategy.server_update_scaffold(
                self.server_state, self.params, mean_delta, mean_dc, fed,
                part_frac)
        else:
            new_params, new_ss = protocol.server_update(
                self.server_state, self.params, mean_delta)
        return new_params, new_ss, ncs, loss

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
        if self.sim.selector == "random":
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
        cstates = (self.protocol.store.gather("state", picks)
                   if self.stateful else None)
        n_examples = torch.tensor([len(self.parts[int(c)]) for c in picks],
                                  dtype=torch.float32, device=self.device)
        with self.telemetry.tracer.span("round"):
            (self.params, self.server_state, ncs,
             loss) = self._round(xb, yb, cstates, n_examples)
        if self.stateful:
            self.protocol.store.scatter("state", picks, ncs)
        self.refs.dispatch(picks, self._rounds_done)
        self._rounds_done += 1
        self.transport.account_uplink(len(picks))
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
