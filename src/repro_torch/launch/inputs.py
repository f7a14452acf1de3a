"""Stand-ins for every model input of the dry-run (counterpart of the JAX
package's ``launch/inputs.py``): tensors on the ``meta`` device with the
reference's shapes and dtypes, nothing allocated, each returned beside its
spec (``sharding/specs.py``) on the mesh it is planned for.

Shape semantics per input shape:
* train_4k    — one FedADC round: tokens (CP, CS, H, b, L) with
                CP·CS = clients_per_round, H local steps, b·(CP·CS·H) =
                global_batch sequences per round.
* prefill_32k — serve-side full forward: tokens (B, L).
* decode_32k / long_500k — serve_step: tokens (B, 1), cache of seq_len.

Modality stubs: whisper gets frame embeddings (B, L, d_model) standing in
for the conv/mel frontend; the VLM gets patch embeddings (B, n_patch,
``VIS_EMBED_DIM``) standing in for InternViT.

Each input function returns ``(tensors, specs)``: two trees of one
structure.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import (FedConfig, ModelConfig, RunConfig,
                                      ShapeConfig)
from repro_torch.models.transformer import VIS_EMBED_DIM
from repro_torch.sharding import specs as S

META = "meta"


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def round_decomposition(shape: ShapeConfig, fed: FedConfig, mesh,
                        multi_pod: bool) -> Tuple[int, int, int, int]:
    """global_batch -> (CP, CS, H, b)."""
    CP = mesh.shape.get("pod", 1) if multi_pod else 1
    H = fed.local_steps
    R = fed.clients_per_round
    assert R % CP == 0, "clients_per_round must divide over pods"
    CS = R // CP
    b = shape.global_batch // (R * H)
    assert b * R * H == shape.global_batch, (
        f"global_batch {shape.global_batch} != clients {R} × H {H} × b {b}")
    return CP, CS, H, b


def train_inputs(mcfg: ModelConfig, shape: ShapeConfig, fed: FedConfig,
                 mesh, multi_pod: bool) -> Tuple[Dict, Dict]:
    CP, CS, H, b = round_decomposition(shape, fed, mesh, multi_pod)
    L = shape.seq_len
    lead = "pod" if (multi_pod and "pod" in mesh.shape) else None
    bspec = (lead, None, None,
             "data" if b % mesh.shape.get("data", 1) == 0 else None, None)
    batch = {"tokens": _meta((CP, CS, H, b, L), torch.int32),
             "labels": _meta((CP, CS, H, b, L), torch.int32)}
    specs = {"tokens": bspec, "labels": bspec}
    from repro_torch.federated.transport import Transport
    if Transport(fed).ef_enabled:
        # the round's client identities, addressing the EF store
        batch["client_ids"] = _meta((CP, CS), torch.int32)
        specs["client_ids"] = (lead, None)
    if mcfg.is_encoder_decoder:
        Ld = min(L, mcfg.max_seq_len)
        batch["frames"] = _meta((CP, CS, H, b, Ld, mcfg.d_model),
                                torch.bfloat16)
        specs["frames"] = bspec + (None,)
        # decoder tokens bounded by learned positions
        batch["tokens"] = _meta((CP, CS, H, b, Ld), torch.int32)
        batch["labels"] = batch["tokens"]
    if mcfg.n_patch_tokens > 0:
        batch["patch_embeds"] = _meta((CP, CS, H, b, mcfg.n_patch_tokens,
                                       VIS_EMBED_DIM), torch.bfloat16)
        specs["patch_embeds"] = bspec + (None,)
    return batch, specs


def prefill_inputs(mcfg: ModelConfig, shape: ShapeConfig, mesh,
                   multi_pod: bool) -> Tuple[Dict, Dict]:
    B, L = shape.global_batch, shape.seq_len
    lead = S.serve_batch_spec(mesh, B, multi_pod)[0]
    batch = {"tokens": _meta((B, L), torch.int32),
             "labels": _meta((B, L), torch.int32)}
    specs = {"tokens": (lead, None), "labels": (lead, None)}
    if mcfg.is_encoder_decoder:
        batch["frames"] = _meta((B, L, mcfg.d_model), torch.bfloat16)
        specs["frames"] = (lead, None, None)
        batch["tokens"] = _meta((B, min(L, mcfg.max_seq_len)), torch.int32)
        batch["labels"] = batch["tokens"]
    if mcfg.n_patch_tokens > 0:
        batch["patch_embeds"] = _meta((B, mcfg.n_patch_tokens,
                                       VIS_EMBED_DIM), torch.bfloat16)
        specs["patch_embeds"] = (lead, None, None)
    return batch, specs


def decode_inputs(mcfg: ModelConfig, shape: ShapeConfig, mesh,
                  multi_pod: bool, cache_dtype=torch.bfloat16):
    """-> ((cache, tokens, cur_pos, active), their specs).

    Decoder-only archs take the continuous-batching inner step: per-slot
    positions (B,) and an (B,) active mask.  Enc-dec keeps the
    batch-synchronous scalar cur_pos (active is None)."""
    from repro_torch.launch.serve import cache_shapes
    B, L = shape.global_batch, shape.seq_len
    cache = cache_shapes(mcfg, B, L, cache_dtype)
    cache_specs = S.cache_shardings(cache, mesh)
    bspec = S.serve_batch_spec(mesh, B, multi_pod)
    tokens = _meta((B, 1), torch.int32)
    if mcfg.is_encoder_decoder:
        cur_pos, pos_spec = _meta((), torch.int32), ()
        active, active_spec = None, None
    else:
        cur_pos, pos_spec = _meta((B,), torch.int32), (bspec[0],)
        active, active_spec = _meta((B,), torch.bool), (bspec[0],)
    return ((cache, tokens, cur_pos, active),
            (cache_specs, bspec, pos_spec, active_spec))


def state_inputs(mcfg: ModelConfig, fed: FedConfig, run: RunConfig, mesh,
                 mode: str = "train"):
    """The pod engine's train state on ``meta`` (``train.state_shapes``)
    and its specs: every leaf that mirrors a parameter (θ, the server's m,
    the EF store's rows, the delta downlink's reference) takes that
    parameter's spec; the store's leading client axis pads a None."""
    from repro_torch.launch.train import state_shapes
    st = state_shapes(mcfg, fed, run)

    def specs_of(tree):
        return S.param_shardings(tree, mesh, mode=mode)
    specs = {"params": specs_of(st["params"]),
             "server": specs_of(st["server"]) if st["server"] else {},
             "round": ()}
    for key in ("clients", "refs"):
        if key in st:
            specs[key] = specs_of(st[key])
    return st, specs


def _shard_factor(spec, mesh) -> int:
    n = 1
    for ax in spec or ():
        for name in (ax if isinstance(ax, tuple) else (ax,)):
            if name is not None:
                n *= mesh.shape.get(name, 1)
    return n


def _spec_leaves(specs):
    if isinstance(specs, dict):
        return [s for v in specs.values() for s in _spec_leaves(v)]
    return [specs]


def sharded_bytes(tree, specs=None, mesh=None) -> float:
    """A device's bytes of ``tree`` laid out by ``specs`` on ``mesh``;
    without them, the whole tree's (a ``meta`` one counts what the card
    would hold)."""
    from repro_torch.core import tree as T
    leaves = T.leaves(tree)
    if mesh is None:
        return sum(x.numel() * x.element_size() for x in leaves)
    return sum(x.numel() * x.element_size() / _shard_factor(sp, mesh)
               for x, sp in zip(leaves, _spec_leaves(specs)))


def state_nbytes(state, specs=None, mesh=None):
    """The bytes of a train state's tensor leaves (θ, the server's state,
    the EF store, the references): a device's share under ``specs`` on
    ``mesh``, or, without them, all of them."""
    return sum(sharded_bytes(state[k], specs and specs[k], mesh)
               for k in ("params", "server", "clients", "refs")
               if k in state and state[k])
