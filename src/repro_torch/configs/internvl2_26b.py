"""internvl2-26b [vlm] — InternViT (stub frontend) + InternLM2-20B language
backbone [arXiv:2404.16821].  ``input_specs`` provides precomputed patch
embeddings; the framework implements the LM that consumes them."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    n_patch_tokens=256,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)
