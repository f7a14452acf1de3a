"""whisper-small [audio] — encoder-decoder; the mel-spectrogram + conv
frontend is a STUB (``input_specs`` yields frame embeddings) per the
assignment [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=12,              # decoder layers
    n_encoder_layers=12,
    is_encoder_decoder=True,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    max_seq_len=4096,         # decoder positions (learned); frames unbounded
    tie_embeddings=True,
)
