"""Virtual-clock, event-driven semi-asynchronous federated engine
(counterpart of the JAX package's ``federated/async_engine.py``).

The synchronous engine barriers every round on the slowest selected client;
under speed heterogeneity (``federated/hetero.py``) that straggler bound
dominates wall-clock.  This engine removes the barrier:

* ``clients_per_round`` clients are kept in flight; each trains on the
  parameter version it was dispatched with and finishes after ``H_i /
  speed_i`` units of virtual time (one unit = one local step on the
  reference client);
* finished deltas enter a server buffer; when it holds ``fed.buffer_k``
  deltas (``buffer_k == 0`` means ``clients_per_round``, the synchronous
  barrier) the server applies one update and re-dispatches the freed slots;
* a delta dispatched at version v and aggregated at version v+s is s
  versions stale, and is scaled by ``staleness_discount(s)`` times its
  FedNova factor H_ref/H_i before the aggregate.

Dispatched clients with equal H_i train as one group: one call of the
simulator's client half (``_client_half``: the H local steps of all of
them stacked, then the uplink), so a group of H_i steps launches the local
step's kernels H_i times.  A flush is one call of the server half
(``_server_half``: weights, aggregate, server step).  With heterogeneity
off, every wave arrives together, each flush sees staleness 0 and scale 1,
and the engine reproduces the synchronous simulator's rounds bit for bit
on the CPU.

In-flight records hold views of their group's stacked uplink (a client's
row of each leaf): no copy at dispatch, at the cost of keeping a group's
stacked tensors alive until its last member is flushed or dropped.  The
flush stacks the buffer's rows into the contiguous operands the leaf-table
kernels take.  A sparse-native record holds its SparseLeaf wire, and only
its values are scaled at the flush.

Scheduling is a deterministic function of the seeds: client sampling
draws from the simulator's RandomState in dispatch order (or the fleet
scheduler's own), and availability, drops and jitter from the
ClientSystemModel's RandomState in event order, so the event log equals
the reference's tuple for tuple.  QSGD's uniforms come from the engine's
``uniforms`` source under names that key on the dispatch counter
(``(dispatch, "uplink", ...)``) and the server version
(``(version, "downlink", ...)``), where the reference folds the same two
counters into its keys.
"""
from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, HeteroConfig
from repro_torch.core import tree as T
from repro_torch.core.selection import SELECTORS
from repro_torch.federated.compression import (SparseLeaf, UniformDraws,
                                               is_sparse_leaf)
from repro_torch.federated.hetero import ClientSystemModel, staleness_discount
from repro_torch.federated.simulator import FederatedSimulator, SimConfig

EVENT_LOG_MAXLEN = 65536

# strategies with per-client cross-round state cannot ride the async engine
# (a stale client would need its state rolled forward)
ASYNC_UNSUPPORTED = ("scaffold", "feddyn", "moon")


@dataclass
class _InFlight:
    """One dispatched client round, finished at `finish_time`."""
    client: int
    version: int                  # parameter version trained against
    delta: object                 # tree: views of the group's uplink rows
    loss: float
    n_examples: float
    delta_scale: float            # FedNova H_ref/H_i normalisation
    finish_time: float


def _row(x, j):
    return SparseLeaf(x.values[j], x.indices[j]) if is_sparse_leaf(x) \
        else x[j]


def _stack(*rows):
    if is_sparse_leaf(rows[0]):
        return SparseLeaf(torch.stack([r.values for r in rows]),
                          torch.stack([r.indices for r in rows]))
    return torch.stack(rows)


def _scale_rows(x, scales):
    """Each client row times its scale; a sparse wire scales its values
    only, which is exactly scaling its dense reconstruction."""
    if is_sparse_leaf(x):
        return x._replace(values=_scale_rows(x.values, scales))
    return x * scales.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


class AsyncFederatedSimulator(FederatedSimulator):
    _engine_name = "async"

    def __init__(self, fed: FedConfig, sim: SimConfig, hetero: HeteroConfig,
                 x_train, y_train, x_test, y_test, parts: List[np.ndarray],
                 telemetry=None, scheduler=None, store=None, params=None,
                 device=None, uniforms=None):
        if fed.strategy in ASYNC_UNSUPPORTED:
            raise ValueError(
                f"async engine supports stateless-client strategies only; "
                f"use the synchronous simulator for {fed.strategy!r}")
        super().__init__(fed, sim, x_train, y_train, x_test, y_test, parts,
                         telemetry=telemetry, store=store, params=params,
                         device=device, uniforms=uniforms,
                         scheduler=scheduler)
        self.hetero = hetero
        self.system = ClientSystemModel(hetero, self.n_clients,
                                        fed.local_steps)
        self.version = 0              # number of server updates applied
        self.vtime = 0.0              # virtual clock
        # (kind, time, client, version) events, bounded so a long-lived
        # engine holds bounded host memory
        self.event_log: Deque[tuple] = deque(maxlen=EVENT_LOG_MAXLEN)
        # the staleness summary, reset at each run()
        self.staleness_hist = self.telemetry.histogram("staleness")
        self._dispatch_ctr = 0        # names the uplink draws, event order
        self._seq = 0

    # ------------------------------------------------------------------
    def _broadcast(self):
        """The version-v broadcast: one wire per server version, memoised
        in the ``ReferenceStore``, so every dispatch at version v gets the
        same reconstruction and the delta codec's reference advances once
        per version."""
        def compute(ref):
            key = UniformDraws(self.uniforms, (self.version, "downlink"),
                               self.device)
            with self.telemetry.tracer.span("transport.encode") as sp:
                out = self.protocol.client_ctx(
                    self.server_state, self.params,
                    key if self._lossy_downlink else None, ref)
                if self.telemetry.enabled:
                    sp.sync = out[0]
            return out
        return self.refs.broadcast(self.version, compute)

    def _sample_clients(self, n: int) -> np.ndarray:
        if self.scheduler is not None:
            # the fleet scheduler's availability/speed-weighted draw (its
            # own RandomState); a redispatch of 1 has no region split
            return self.scheduler.sample(n)
        sel = SELECTORS[self.sim.selector]

        def draw():
            if self.sim.selector == "random":
                return sel(self.rng, self.n_clients, n)
            return sel(self.rng, self.n_clients, n, self.counts)

        picks = draw()
        if self.hetero.enabled and self.hetero.availability < 1.0:
            # best effort: redraw until the whole wave is reachable
            for _ in range(20):
                if all(self.system.is_available(int(c)) for c in picks):
                    break
                picks = draw()
        return picks

    def _dispatch(self, heap: list, n: int, now: float):
        """Sample n clients, run their local rounds against the current
        parameters, and schedule their arrivals.  Clients with equal H_i
        train as one group; with a homogeneous fleet that is the
        synchronous round's client computation."""
        if n <= 0:
            return
        picks = self._sample_clients(n)
        params_w, ctx = self._broadcast()
        by_h: Dict[int, List[int]] = {}
        for c in picks:
            by_h.setdefault(int(self.system.local_steps[int(c)]), []).append(
                int(c))
        for h, group in by_h.items():
            xs, ys = zip(*[self._client_batches(c, local_steps=h)
                           for c in group])
            xb = torch.from_numpy(np.stack(xs)).to(self.device)
            yb = torch.from_numpy(np.stack(ys)).to(self.device).long()
            counts = torch.as_tensor(self.counts[group], dtype=torch.float32,
                                     device=self.device)
            efs = self.protocol.store.gather("ef", group)
            up_key = UniformDraws(self.uniforms,
                                  (self._dispatch_ctr, "uplink"), self.device)
            self._dispatch_ctr += 1
            with self.telemetry.tracer.span("local_train") as sp:
                deltas, _, new_efs, losses, _ = self._client_half(
                    params_w, ctx, xb, yb, counts, None, efs, up_key)
                if self.telemetry.enabled:
                    sp.sync = deltas
            if self.ef_enabled:
                self.protocol.store.scatter("ef", group, new_efs)
            # one host fetch for the group's per-client mean losses
            losses = losses.mean(0).tolist()
            # every dispatched client receives the version-v broadcast: the
            # downlink is paid at dispatch (a dropped upload loses only the
            # uplink); unicast classifies each client against the last
            # version it saw
            self.refs.dispatch(group, self.version, wire=(params_w, ctx))
            for j, c in enumerate(group):
                rec = _InFlight(
                    client=c, version=self.version,
                    delta=T.tree_map(lambda x: _row(x, j), deltas),
                    loss=losses[j],
                    n_examples=float(len(self.parts[c])),
                    delta_scale=self.system.delta_scale(c),
                    finish_time=now + self.system.round_time(c))
                self._seq += 1
                heapq.heappush(heap, (rec.finish_time, self._seq, rec))
                self.event_log.append(("dispatch", now, c, self.version))

    def _flush(self, buffer: List[_InFlight]) -> float:
        """Apply one buffered-K server update from the collected deltas ->
        the buffer's mean local loss.  With telemetry on, the drift
        diagnostics over the scaled rows (what the server averaged) are
        recorded under the new version, with the staleness seen."""
        fed, tel = self.fed, self.telemetry
        stale = np.asarray([self.version - r.version for r in buffer])
        self.staleness_hist.observe_many(int(s) for s in stale)
        disc = staleness_discount(stale, fed.staleness_mode,
                                  fed.staleness_factor)
        scales = torch.from_numpy(np.asarray(
            disc * np.asarray([r.delta_scale for r in buffer]),
            np.float32)).to(self.device)
        n_ex = torch.from_numpy(np.asarray([r.n_examples for r in buffer],
                                           np.float32)).to(self.device)
        stacked = T.tree_map(lambda *rows: _scale_rows(_stack(*rows), scales),
                             *[r.delta for r in buffer])
        drift = {} if tel.enabled else None
        with tel.tracer.span("aggregate") as sp:
            self.params, self.server_state = self._server_half(stacked,
                                                               n_ex, drift)
            if tel.enabled:
                sp.sync = self.params
        self.version += 1
        loss = float(np.mean([r.loss for r in buffer]))
        if tel.enabled:
            names = sorted(drift)    # one host fetch a flush
            vals = torch.stack([drift[k] for k in names]).tolist()
            tel.record_round(self.version, {
                **dict(zip(names, vals)), "loss": loss,
                "staleness_mean": float(stale.mean()),
                "staleness_max": float(stale.max()),
            })
        return loss

    # ------------------------------------------------------------------
    def run(self, rounds: Optional[int] = None, log_fn: Callable = None):
        """Run until ``rounds`` server updates have been applied.  History
        entries carry the virtual time ``t`` of each update."""
        rounds = self.sim.rounds if rounds is None else rounds
        fed = self.fed
        self.staleness_hist.reset()
        # buffer_k == 0 is the synchronous-barrier sentinel
        K = fed.buffer_k if fed.buffer_k > 0 else fed.clients_per_round
        inflight = max(fed.clients_per_round, K)
        heap: list = []
        buffer: List[_InFlight] = []
        self._seq = 0
        self._dispatch(heap, inflight, self.vtime)
        while self.version < rounds and heap:
            ft, _, rec = heapq.heappop(heap)
            self.vtime = max(self.vtime, ft)
            if self.system.drops_out(rec.client):
                self.event_log.append(("drop", self.vtime, rec.client,
                                       self.version))
                if self.ef_enabled:
                    # the upload is lost: fold its reconstruction back into
                    # the client's EF memory, so mass is conserved even when
                    # the client was re-dispatched meanwhile
                    lost = rec.delta
                    if self.protocol.sparse_native:
                        # the record holds the sparse wire and the EF store
                        # is dense: densify this one delta, bit for bit the
                        # reconstruction the server would have decoded
                        lost = T.tree_map(lambda x: x[0],
                                          self.transport.uplink_decode(
                                              T.tree_map(_stack, lost),
                                              T.tree_map(lambda p: p[None],
                                                         self.params)))
                    cur = self.ef_states.get(rec.client)
                    self.ef_states[rec.client] = T.add(
                        self._ef_init() if cur is None else cur, lost)
                self._dispatch(heap, 1, self.vtime)
                continue
            self.event_log.append(("arrive", self.vtime, rec.client,
                                   rec.version))
            # a successful upload: dropped clients never transmit
            self.transport.account_uplink(1)
            buffer.append(rec)
            if len(buffer) >= K:
                loss = self._flush(buffer)
                buffer = []
                self.event_log.append(("update", self.vtime, -1,
                                       self.version))
                done = self.version >= rounds
                if not done:
                    self._dispatch(heap, K, self.vtime)
                if self.version % self.sim.eval_every == 0 or done:
                    acc = self.evaluate()
                    self.telemetry.record_eval({"round": self.version,
                                                "t": self.vtime, "acc": acc,
                                                "loss": loss})
                    if log_fn:
                        log_fn(self.history[-1])
        return self.history
