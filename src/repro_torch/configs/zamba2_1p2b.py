"""zamba2-1.2b [hybrid] — Mamba2 backbone with a single globally-shared
attention block applied after every 6 Mamba blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import MAMBA2, SHARED_ATTN, ModelConfig, SSMConfig


def _pattern(n_mamba: int, every: int):
    pat = []
    for i in range(n_mamba):
        pat.append(MAMBA2)
        if (i + 1) % every == 0:
            pat.append(SHARED_ATTN)
    return tuple(pat)


CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    head_dim=64,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, n_groups=1, head_dim=64,
                  chunk_size=256),
    block_pattern=_pattern(38, 6),
    shared_attn_every=6,
    max_seq_len=524_288,
    tie_embeddings=True,
)
