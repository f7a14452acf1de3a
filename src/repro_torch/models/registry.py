"""Model registry (counterpart of the JAX package's ``models/registry.py``):
the uniform (init, forward, loss, cache, decode) bundle per architecture,
and the parameter count from shapes alone."""
from __future__ import annotations

import math
from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, tree_map_with_path
from repro_torch.models import encdec, transformer


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """The encoder-decoder module for Whisper-style configs, the
    decoder-only stack for every other."""
    mod = encdec if cfg.is_encoder_decoder else transformer
    return SimpleNamespace(init=mod.init, forward=mod.forward,
                           loss_fn=mod.loss_fn, init_cache=mod.init_cache,
                           decode_step=mod.decode_step)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count from an init on the ``meta`` device: shapes
    only, nothing allocated.  ``active_only`` counts each routed-expert
    leaf at top_k / n_experts (integer division a leaf), as the reference
    does; the router and the shared expert count in full."""
    def size(path, t):
        n = math.prod(t.shape)
        if active_only and cfg.moe is not None and "experts" in path:
            n = n * cfg.moe.top_k // max(cfg.moe.n_experts, 1)
        return n
    params = get_model(cfg).init(0, cfg, device="meta")
    return sum(leaves(tree_map_with_path(size, params)))
