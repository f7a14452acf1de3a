"""llama4-scout-17b-a16e [moe] — 16 routed experts top-1 + shared expert,
iRoPE-style attention interleave (3 chunked/windowed layers : 1 global),
early-fusion multimodal (text path implemented; vision stub not required for
this entry) [hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=1, n_shared_experts=1,
                  d_ff_expert=8192, capacity_factor=1.25),
    sliding_window=8192,
    global_attn_every=4,
    rope_theta=500_000.0,
    max_seq_len=524_288,
)
