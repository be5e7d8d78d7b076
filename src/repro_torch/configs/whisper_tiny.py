"""whisper-tiny: encoder-decoder, 4 encoder and 4 decoder layers, d_model
384, 6 heads of 64 (kv 6), d_ff 1536, vocab 51865.  Same numbers as
``repro.configs.whisper_tiny``.  The conv frontend is a stub, as in the
reference: the encoder takes precomputed frame embeddings ``[B, T, d]``
(T = 1500 frames is Whisper's 30-second window)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,            # decoder layers
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests (the reference's own)."""
    return CONFIG.replace(n_layers=2, encoder_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                          vocab=256, attn_chunk=32)
