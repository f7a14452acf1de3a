"""Model registry (counterpart of the JAX package's ``models/registry.py``):
the uniform (init, forward, loss, cache, decode) bundle per architecture,
and the parameter count from shapes alone."""
from __future__ import annotations

import math
from types import SimpleNamespace

from repro_torch.configs.base import ModelConfig
from repro_torch.core.tree import leaves, tree_map_with_path
from repro_torch.models import transformer


def get_model(cfg: ModelConfig) -> SimpleNamespace:
    """Raises ``NotImplementedError`` for what the port cannot build yet
    (encoder-decoder models, MoE, xLSTM, MLA, the VLM prefix)."""
    transformer.check_supported(cfg)
    return SimpleNamespace(init=transformer.init, forward=transformer.forward,
                           loss_fn=transformer.loss_fn,
                           init_cache=transformer.init_cache,
                           decode_step=transformer.decode_step)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count from an init on the ``meta`` device: shapes
    only, nothing allocated.  ``active_only`` counts the routed experts
    at top_k / n_experts, as the reference does; this stack builds no
    experts, so for what it builds the two counts agree."""
    def size(path, t):
        n = math.prod(t.shape)
        if active_only and cfg.moe is not None and "experts" in path:
            n = n * cfg.moe.top_k // max(cfg.moe.n_experts, 1)
        return n
    params = get_model(cfg).init(0, cfg, device="meta")
    return sum(leaves(tree_map_with_path(size, params)))
