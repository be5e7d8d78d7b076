"""qwen2.5-32b: dense, 64 layers, d_model 5120, 40 query heads over 8 KV
heads of 128, d_ff 27648, vocab 152064, q/k/v biases, RoPE theta 1e6.
Same numbers as ``repro.configs.qwen2_5_32b``.  65.5 GB in bf16: served on
one 80 GB card only with a short cache (not yet run on the card).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab=152064,
    rope_theta=1e6,
    qkv_bias=True,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                          head_dim=16, d_ff=160, vocab=256, attn_chunk=32)
