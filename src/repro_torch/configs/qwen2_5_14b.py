"""qwen2.5-14b: dense, 48 layers, d_model 5120, 40 query heads over 8 KV
heads of 128 (GQA, 5 query heads a KV head), d_ff 13824, vocab 152064,
biases on the q, k and v projections, RoPE theta 1e6.  Same numbers as
``repro.configs.qwen2_5_14b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab=152064,
    rope_theta=1e6,
    qkv_bias=True,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
                          head_dim=16, d_ff=96, vocab=256, attn_chunk=32)
