"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts, first 3
layers dense [arXiv:2412.19437].  MTP (multi-token prediction) head is out of
scope for the FL reproduction (noted in DESIGN.md)."""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # dense layers (first 3)
    vocab_size=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, n_shared_experts=1,
                  d_ff_expert=2048, first_k_dense=3, capacity_factor=1.25),
    rope_theta=10_000.0,
    max_seq_len=131_072,
)
