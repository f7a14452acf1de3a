"""The pod engine on one card (counterpart of the JAX package's
``launch/train.py``): one FedADC communication round of an LM.

The reference maps a round onto a pod mesh: H local steps as a
``lax.scan``, the clients of a pod client-serially (a second scan, Δ
accumulated by linearity), pods in parallel (``vmap``), and one cross-pod
recombine.  On one card every scan is a Python loop:

* the H local steps of a client, each step's gradient taken with
  ``torch.autograd.grad`` over the parameter dict (so a model under
  ``remat`` recomputes its blocks in the backward pass);
* the CS clients of a pod, one at a time, their weighted deltas added into
  an fp32 accumulator per leaf: the memory holds one model copy per role
  (θ_t, ctx, the local θ, its gradient), never the round's clients
  stacked;
* the CP pods in turn, each filling its row of a (CP, ...) fp32 buffer; the
  rows recombine through ``strategy.server_aggregate`` (the weighted-reduce
  kernel) or ``fleet.hierarchy.hierarchical_combine``, as the reference's
  pods do.

The port's strategies take client-stacked trees, so a client's θ, gradient
and ctx carry a leading axis of 1 (views).  On CUDA tensors the local
steps, the wire and the server step launch the port's kernels, as in the
simulator; the LM forward takes the kernel route only under
``fed.use_pallas``, and on the card that route refuses a gradient, as the
reference's Pallas kernels do, so the engine trains on the plain route.

Mixed precision (``RunConfig`` defaults): θ_t and the server's m are
broadcast in bf16 and the local steps run in bf16; Δ accumulates in fp32
whatever the wire dtype, and the master θ and m stay in the parameter
dtype.

The uplink rides ``Transport`` client by client against the client's
error-feedback residual, kept in a stacked device store in the train state
(``state["clients"]["ef"]``, ``federated/store.py``'s ``sharded_*``); a
sparse-native top-k wire is added into the accumulator with ``index_add_``
at k cost.  The lossy delta downlink's reference rides in
``state["refs"]``.  Random draws (QSGD up and down) come from ``uniforms=``,
a source ``(name, shape, dtype, device) -> tensor`` asked once per leaf
with ``name = (round, pod, client, "uplink", leaf path)`` or ``(round,
None, None, "downlink", ...)``; by default a ``torch.Generator`` on the
device seeded from ``(run.seed, round)``.  ``state["round"]`` is a Python
int, so seeding it reads nothing back from the card.

``train_step(state, batch)`` is one round: ``batch["tokens"]`` (CP, CS, H,
b, L), the same leading axes on ``labels`` and, where the model takes
them, ``frames`` or ``patch_embeds``; ``batch["client_ids"]`` (CP, CS)
names the round's clients for the EF store (default slots 0..CP·CS−1).
It returns (new state, aux) with ``aux["loss"]`` and, under an enabled
``Telemetry``, ``aux["telemetry"]``: device tensors the caller fetches.
The EF store is updated in place; every other leaf of the new state is a
new tensor.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FedConfig, ModelConfig, RunConfig
from repro_torch.core import distillation as D
from repro_torch.core import tree as T
from repro_torch.core.strategies import get_strategy
from repro_torch.device import resolve_device
from repro_torch.federated import aggregation as A
from repro_torch.federated import store as CS
from repro_torch.federated.compression import (GeneratorUniforms,
                                               SparseLeaf, UniformDraws,
                                               is_sparse_leaf)
from repro_torch.federated.fleet import hierarchy as FH
from repro_torch.federated.reference import ReferenceStore
from repro_torch.federated.transport import Transport
from repro_torch.models.registry import get_model
from repro_torch.telemetry import drift as drift_metrics

POD_SUPPORTED = ("fedavg", "slowmo", "fedadc", "fedadc_double", "fedprox",
                 "fedadc+")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _mixed(run: RunConfig) -> bool:
    return (_dtype(run.param_dtype) == torch.float32
            and _dtype(run.compute_dtype) == torch.bfloat16)


def _wire_dtype(run: RunConfig) -> torch.dtype:
    """The dtype client deltas (and so the EF residuals) live in: the
    compute dtype under the mixed-precision round, else the param dtype."""
    return _dtype(run.compute_dtype) if _mixed(run) \
        else _dtype(run.param_dtype)


def _broadcast_inputs(strategy, params, server, fed: FedConfig,
                      run: RunConfig):
    """(θ_t, server view, ctx, mixed) in the wire dtype: the mixed round
    broadcasts bf16.  Shared by ``init_state`` (the delta codec's round-0
    reference must equal the round-0 broadcast bit for bit) and the
    round."""
    mixed = _mixed(run)
    theta_t = T.cast(params, _dtype(run.compute_dtype)) if mixed else params
    server_view = server
    if mixed and "m" in server:
        server_view = dict(server, m=T.cast(server["m"],
                                            _dtype(run.compute_dtype)))
    ctx = strategy.client_setup(server_view, theta_t, fed)
    return theta_t, server_view, ctx, mixed


def init_state(seed: int, mcfg: ModelConfig, fed: FedConfig, run: RunConfig,
               device=None, params=None) -> Dict:
    """The train state: parameters (the model's init from ``seed`` on
    ``device``, the card unless given, or ``params`` moved there), the
    strategy's server state, the round counter, and the EF store and the
    downlink reference where the wire needs them."""
    device = resolve_device(device)
    dtype = _dtype(run.param_dtype)
    if params is None:
        params = get_model(mcfg).init(seed, mcfg, dtype=dtype, device=device)
    else:
        params = T.tree_map(lambda t: t.to(device=device, dtype=dtype),
                            params)
    strategy = get_strategy(fed.strategy)
    state = {"params": params, "server": strategy.server_init(params),
             "round": 0}
    transport = Transport(fed)
    if transport.ef_enabled:
        # one residual per client of the fleet, in the wire's dtype
        state["clients"] = {"ef": CS.sharded_init(
            T.cast(params, _wire_dtype(run)), fed.n_clients)}
    if transport.stateful_downlink:
        # only the lossy delta codec keeps a reference; the round-0
        # reference is the initial sync
        theta_w, _, ctx0, _ = _broadcast_inputs(strategy, params,
                                                state["server"], fed, run)
        state["refs"] = {"downlink": transport.init_downlink_ref(theta_w,
                                                                 ctx0)}
    return state


def state_shapes(mcfg: ModelConfig, fed: FedConfig, run: RunConfig) -> Dict:
    """The train state on the ``meta`` device: shapes and dtypes, nothing
    allocated."""
    return init_state(0, mcfg, fed, run, device="meta")


def _token_histogram(tokens, vocab: int, valid=None):
    """Client token statistics for the FedADC+ ρ vector; positions with
    ``valid`` False (padding) are excluded."""
    flat = tokens.reshape(-1).long()
    w = torch.ones(flat.shape, dtype=torch.float32, device=flat.device) \
        if valid is None else valid.reshape(-1).float()
    return torch.zeros((vocab,), dtype=torch.float32,
                       device=flat.device).index_add_(0, flat, w)


def _local_objective(model, mcfg: ModelConfig, fed: FedConfig,
                     run: RunConfig):
    """-> loss(theta, step_batch, theta_t, rho) of one local step."""
    use_pallas = fed.use_pallas

    def loss(theta, sb, theta_t, rho):
        if not fed.distill:
            return model.loss_fn(theta, sb, mcfg, use_pallas, run.remat)[0]
        # FedADC+ self-confidence KD: the teacher is the broadcast θ_t
        # (eqs. 7-9), ρ the client's token statistics
        s_logits, aux_l = model.forward(theta, sb, mcfg, use_pallas,
                                        run.remat)
        with torch.no_grad():
            t_logits, _ = model.forward(theta_t, sb, mcfg, use_pallas,
                                        run.remat)
        if mcfg.n_patch_tokens > 0 and "patch_embeds" in sb:
            n_patch = sb["patch_embeds"].shape[1]
            s_logits, t_logits = s_logits[:, n_patch:], t_logits[:, n_patch:]
        labels = sb["labels"][:, 1:]
        s_l, t_l = s_logits[:, :-1], t_logits[:, :-1]
        V = s_l.shape[-1]
        kd, _ = D.masked_self_confidence_kd_loss(
            s_l.reshape(-1, V), t_l.reshape(-1, V),
            labels.reshape(-1).clamp_min(0), rho, fed.distill_lambda,
            fed.distill_tau, (labels >= 0).reshape(-1))
        return kd + 0.0 * aux_l
    return loss


def _like(tree, outs):
    """``outs`` (in leaf order) placed in a tree of ``tree``'s structure."""
    it = iter(outs)
    return T.tree_map(lambda _: next(it), tree)


def _one(tree):
    """A tree as one client's stacked tree: a leading axis of 1 (views)."""
    return T.tree_map(lambda x: x.unsqueeze(0), tree)


def _unstacked(tree):
    """One client's stacked tree (dense or SparseLeaf wire) without its
    leading axis of 1 (views)."""
    def leaf(x):
        if is_sparse_leaf(x):
            return SparseLeaf(x.values[0], x.indices[0])
        return x[0]
    return T.tree_map(leaf, tree)


def make_train_step(mcfg: ModelConfig, fed: FedConfig, run: RunConfig,
                    client_parallel: int = 1, telemetry=None, uniforms=None):
    """-> train_step(state, batch): one communication round.

    ``client_parallel`` is the reference's (its pod count comes from the
    batch, CP); ``uniforms`` the source of QSGD's draws (module
    docstring).  With an enabled ``telemetry`` the aux dict gains a
    ``"telemetry"`` dict of drift scalars (streaming weighted dispersion,
    ||Δ̄||, momentum alignment, EF-residual norm); with telemetry off the
    round makes the same calls as with none.

    The round consumes the EF store of the state it is given: the new
    state's ``state["clients"]["ef"]`` is that same tree, its rows written
    in place (``store.sharded_scatter``), so a caller that keeps the old
    state to retry or checkpoint the round must clone the store first.
    Every other leaf of the new state is a new tensor."""
    with_metrics = telemetry is not None and telemetry.enabled
    if fed.strategy not in POD_SUPPORTED:
        raise ValueError(
            f"pod engine supports stateless-client strategies {POD_SUPPORTED};"
            f" use the simulator for {fed.strategy} (per-client state).")
    if fed.aggregator == "drag" and fed.strategy in ("fedavg", "fedprox"):
        raise ValueError(
            "drag aggregation in the pod engine needs a server-momentum "
            "reference (slowmo/fedadc/fedadc_double); the client-serial "
            "loop has no round mean to fall back on.")
    transport = Transport(fed)
    transported = transport.up is not None
    sparse_native = transport.sparse_native
    ef_enabled = transport.ef_enabled
    lossy_down = transport.down is not None and transport.down.lossy
    model = get_model(mcfg)
    strategy = get_strategy(fed.strategy)
    loss_fn = _local_objective(model, mcfg, fed, run)

    def round_source(round_no, device):
        """The round's uniform source: ``uniforms``, else a generator on
        the device seeded from (run.seed, round)."""
        if uniforms is not None:
            return uniforms
        return GeneratorUniforms((run.seed * 1_000_003 + round_no)
                                 % (1 << 63), device)

    def step_grad(sb, theta_t, rho):
        """grad_fn for a strategy's local step on one step's batch."""
        def grad_fn(theta, _batch):
            leaves = [x[0].detach().requires_grad_() for x in T.leaves(theta)]
            with torch.enable_grad():
                l = loss_fn(_like(theta, leaves), sb, theta_t, rho)
                gs = torch.autograd.grad(l, leaves, allow_unused=True)
            # a leaf the loss does not reach (vis_proj without patches) has
            # a zero gradient, as jax.grad gives it
            return _like(theta, [
                (torch.zeros_like(x) if g is None else g.contiguous())
                .unsqueeze(0) for x, g in zip(leaves, gs)]), l.detach()
        return grad_fn

    def client_delta(theta_t, theta_1, ctx_1, cb):
        """cb: one client's batch, leading (H, b) -> (Δ stacked (1, ...),
        mean loss over its steps)."""
        rho = None
        if fed.distill:
            hist = _token_histogram(cb["tokens"], mcfg.vocab_size,
                                    valid=cb["labels"] >= 0)
            rho = hist / torch.clamp(hist.max(), min=1.0)
        theta, extra = theta_1, strategy.init_extra(theta_1, fed)
        losses = []
        for h in range(cb["tokens"].shape[0]):
            sb = {k: v[h] for k, v in cb.items()}
            theta, extra, l = strategy.local_step(
                theta, ctx_1, step_grad(sb, theta_t, rho), None, fed, extra)
            losses.append(l)
        return T.sub(theta_1, theta), torch.stack(losses).mean()

    def pod_group(theta_t, ctx, ref, cbs, acc, efs, source, round_no, pod):
        """The CS clients of pod ``pod`` in turn (cbs: leading (CS, H, b)):
        each client's delta rides the uplink against its EF residual
        (``efs``: the round's gathered residuals, (CS, ...) views, written
        over with the new ones; None when EF is off), and its weighted wire
        reconstruction is added into ``acc`` (fp32, the parameters'
        shapes) -> (Σw, mean loss, Σ w·||Δ||²)."""
        theta_1, ctx_1 = _one(theta_t), _one(ctx)
        device = T.leaves(acc)[0].device
        wsum = torch.zeros((), dtype=torch.float32, device=device)
        sqsum = torch.zeros((), dtype=torch.float32, device=device)
        losses = []
        for c in range(cbs["tokens"].shape[0]):
            d, l = client_delta(theta_t, theta_1, ctx_1,
                                {k: v[c] for k, v in cbs.items()})
            if transported:
                # sparse-native: encode only; the (values, indices) wire is
                # added below at k cost, and the residual from encode is
                # the exact complement the round trip would return
                up = transport.uplink_encode if sparse_native \
                    else transport.uplink
                ef = T.zeros_like(d) if efs is None else \
                    T.tree_map(lambda x: x[c:c + 1], efs)
                key = UniformDraws(source, (round_no, pod, c, "uplink"),
                                   device)
                d, new_ef = up(d, ef, key)
                if efs is not None:
                    T.tree_map(lambda slot, e: slot[c:c + 1].copy_(e), efs,
                               new_ef)
            one = _unstacked(d)
            w = A.streaming_weight(one, ref, fed.aggregator, fed.drag_lambda)
            # Σ w·Δ accumulates in fp32 whatever the wire dtype: a bf16
            # running sum loses the late clients to rounding
            if sparse_native:
                # per coordinate the same client-ordered fp32 add chain as
                # the dense decode path (whose off-support adds are +0.0
                # no-ops); each index occurs once per client, so the
                # device's order of the adds cannot change a bit
                T.tree_map(lambda a, wl: a.view(-1).index_add_(
                    0, wl.indices.long(), wl.values.float() * w), acc, one)
            else:
                T.tree_map(lambda a, x: a.add_(x.float() * w), acc, one)
            wsum = wsum + w
            if with_metrics:
                # one fp32 scalar a client: Σ w·||Δ||² for the streaming
                # dispersion identity
                sqsum = sqsum + drift_metrics.streaming_sq_norm(one, w)
            losses.append(l)
        return wsum, torch.stack(losses).mean(), sqsum

    def train_step(state: Dict, batch: Dict):
        batch = dict(batch)
        client_ids = batch.pop("client_ids", None)
        theta_master = state["params"]
        device = T.leaves(theta_master)[0].device
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        round_no = state["round"]
        theta_t, server_view, ctx, mixed = _broadcast_inputs(
            strategy, theta_master, state["server"], fed, run)
        ref = A.reference_direction(server_view) \
            if fed.aggregator == "drag" else None
        CP, CSn = batch["tokens"].shape[:2]
        new_dref = None
        source = round_source(round_no, device) \
            if transported or lossy_down else None
        if transport.down is not None:
            # clients train on the broadcast reconstruction; only the
            # lossy delta codec keeps reference state (state["refs"])
            dkey = UniformDraws(source, (round_no, None, None, "downlink"),
                                device) if lossy_down else None
            dref = state["refs"]["downlink"] if "refs" in state else None
            theta_t, ctx, new_dref = transport.broadcast(theta_t, ctx, dkey,
                                                         dref)
        efs = ids = None
        if ef_enabled:
            if client_ids is None:
                # default identification: slot i of the round is client i
                client_ids = torch.arange(CP * CSn, device=device)
            ids = torch.as_tensor(client_ids, device=device).reshape(-1)
            efs = CS.sharded_gather(state["clients"]["ef"], ids)
        # one fp32 row per pod: its clients' Σ w·Δ, then its weighted mean
        acc = T.tree_map(lambda p: torch.zeros(
            (CP,) + tuple(p.shape), dtype=torch.float32, device=device),
            theta_master)
        wsums, losses, sqsums = [], [], []
        for p in range(CP):
            rows = None if efs is None else T.tree_map(
                lambda x: x[p * CSn:(p + 1) * CSn], efs)
            wsum, loss, sqsum = pod_group(
                theta_t, ctx, ref, {k: v[p] for k, v in batch.items()},
                T.tree_map(lambda a: a[p], acc), rows, source, round_no, p)
            T.tree_map(lambda a: a[p].div_(wsum), acc)
            wsums.append(wsum)
            losses.append(loss)
            sqsums.append(sqsum)
        del theta_t, ctx
        gweights = torch.stack(wsums)
        loss = losses[0] if CP == 1 else torch.stack(losses).mean()
        # the pods' weighted means recombine exactly through the shared
        # hook: Σ_p W_p·Δ̄_p / Σ_p W_p = Σ_i w_i·Δ_i / Σ_i w_i; under the
        # fleet topology the CP pod partials chunk into fleet_regions
        # regional partials before the global combine (identity at R=1)
        if fed.fleet_regions > 0:
            mean_delta = FH.hierarchical_combine(acc, gweights, fed, strategy)
        else:
            mean_delta = strategy.server_aggregate(acc, gweights, fed)
        del acc
        mean_delta = T.cast(mean_delta, torch.float32 if mixed
                            else _dtype(run.param_dtype))
        new_params, new_server = strategy.server_update(
            state["server"], theta_master, mean_delta, fed)
        new_state = {"params": new_params, "server": new_server,
                     "round": round_no + 1}
        if "refs" in state:
            new_state["refs"] = {"downlink": new_dref}
        if ef_enabled:
            new_state["clients"] = {"ef": CS.sharded_scatter(
                state["clients"]["ef"], ids, efs)}
        aux = {"loss": loss}
        if with_metrics:
            sq_total = sqsums[0] if CP == 1 else torch.stack(sqsums).sum()
            w_total = wsums[0] if CP == 1 else gweights.sum()
            metrics = {
                "delta_dispersion": drift_metrics.streaming_dispersion(
                    sq_total, w_total, mean_delta),
                "update_norm": drift_metrics.update_norm(mean_delta),
            }
            if "m" in state["server"]:
                metrics["momentum_alignment"] = \
                    drift_metrics.momentum_alignment(state["server"]["m"],
                                                     mean_delta)
            if ef_enabled:
                metrics["ef_residual_norm"] = \
                    drift_metrics.ef_residual_norm(efs)
            aux["telemetry"] = metrics
        return new_state, aux

    # measured-byte accounting: the wire templates are the wire trees (the
    # delta and the broadcast in the wire dtype), sized on the meta device
    state_t = state_shapes(mcfg, fed, run)
    theta_w_t, _, ctx_t, _ = _broadcast_inputs(
        strategy, state_t["params"], state_t["server"], fed, run)
    transport.set_wire_templates(theta_w_t, {"params": theta_w_t,
                                             "ctx": ctx_t})
    del state_t

    # the downlink reference layer: multicast accounting and, under
    # fed.downlink_unicast, per-client catch-up/resync bookkeeping;
    # host-side, as the counters are
    refs = ReferenceStore(fed, transport, telemetry=telemetry)

    def account_round(n_clients: Optional[int] = None, resync: bool = False,
                      client_ids=None):
        """Advance the measured-byte counters by one round's traffic; call
        once per executed round.  Multicast (default): ``n_clients``
        dispatched clients, ``resync=True`` for the delta downlink's
        round-0 initial sync.  Unicast (``fed.downlink_unicast``): pass
        ``client_ids`` and each client is classified fresh / catch-up /
        resync against the last round it saw."""
        if client_ids is not None:
            ids = [int(c) for c in np.asarray(client_ids).reshape(-1)]
            refs.dispatch(ids, account_round.round_no)
            account_round.round_no += 1
            transport.account_uplink(len(ids))
            return
        transport.account_downlink(n_clients, resync=resync)
        transport.account_uplink(n_clients)

    account_round.round_no = 0
    train_step.transport = transport
    train_step.refs = refs
    train_step.account_round = account_round
    return train_step
