"""stablelm-12b: dense, 40 layers, d_model 5120, 32 query heads over 8 KV
heads of 160, d_ff 13824, vocab 100352.  Same numbers as
``repro.configs.stablelm_12b``.  head_dim 160 is no multiple of 128: the
attention kernels run it padded to 192 (prefill) or on 20 of a warp's 32
lanes (decode).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    rope_theta=1e4,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=20, d_ff=96, vocab=256, attn_chunk=32)
