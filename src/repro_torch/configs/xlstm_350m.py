"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517].  Every 4th
block is sLSTM (true recurrence), the rest mLSTM (parallel matrix memory)."""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, SSMConfig


def _pattern(n: int):
    return tuple(SLSTM if (i + 1) % 4 == 0 else MLSTM for i in range(n))


CONFIG = ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                   # projections live inside the xLSTM blocks
    vocab_size=50304,
    ssm=SSMConfig(d_state=0, d_conv=4, expand=2, head_dim=256),
    block_pattern=_pattern(24),
    max_seq_len=524_288,
    tie_embeddings=True,
)
