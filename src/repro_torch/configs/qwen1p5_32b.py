"""qwen1.5-32b [dense] — QKV bias, MHA (kv=40) [hf:Qwen/Qwen1.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen1.5-32b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    max_seq_len=32_768,
)
