"""The port's configurations and the architecture registry (the
counterpart of the JAX package's ``configs/__init__.py``).  ``--arch``
takes the exact id, which may contain dots and dashes; module files use
sanitised names.  The ten architecture files are data only, so ``ARCHS``
has the reference's keys whether or not the port can build the model yet
(``repro_torch.models.registry.get_model`` says which it can)."""
from repro_torch.configs import (deepseek_v3_671b, internvl2_26b,
                                 llama4_scout_17b_a16e, mistral_large_123b,
                                 qwen1p5_32b, qwen3_14b, qwen3_4b,
                                 whisper_small, xlstm_350m, zamba2_1p2b)
from dataclasses import replace

from repro_torch.configs.base import (SHAPES, FedConfig, HeteroConfig,
                                      ModelConfig, RunConfig, ShapeConfig)

ARCHS = {
    c.CONFIG.arch_id: c.CONFIG
    for c in (zamba2_1p2b, internvl2_26b, whisper_small, mistral_large_123b,
              deepseek_v3_671b, qwen3_14b, qwen1p5_32b, qwen3_4b, xlstm_350m,
              llama4_scout_17b_a16e)
}


# Dense archs that get the sliding-window serving variant for the long_500k
# shape (the reference's DESIGN.md §Arch-applicability).
_LONG_CTX_WINDOW_VARIANT = {"qwen3-4b": 8192, "qwen3-14b": 8192}


def get_arch(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def long_context_variant(cfg: ModelConfig):
    """Config used for the long_500k shape, or None if the arch skips it."""
    if cfg.supports_long_context:
        return cfg
    if cfg.arch_id in _LONG_CTX_WINDOW_VARIANT:
        return replace(cfg,
                       sliding_window=_LONG_CTX_WINDOW_VARIANT[cfg.arch_id])
    return None


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return long_context_variant(cfg) is not None
    return True


__all__ = ["ARCHS", "SHAPES", "get_arch", "long_context_variant",
           "shape_applicable", "ModelConfig", "FedConfig", "HeteroConfig",
           "RunConfig", "ShapeConfig"]
