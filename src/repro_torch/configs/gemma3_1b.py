"""gemma3-1b: dense, 26 layers, d_model 1152, 4 query heads over one KV
head of 256 (MQA), d_ff 6912, vocab 262144, RoPE theta 1e6.  Layer i is
global iff (i+1) % 6 == 0 (layers 5, 11, 17, 23); the other 22 attend
over a 512-token sliding window (``mixer_kind`` "attn_local").  Same
numbers as ``repro.configs.gemma3_1b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab=262144,
    rope_theta=1e6,
    sliding_window=512,
    global_every=6,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests: 7 layers (one global, layer 5),
    window 8."""
    return CONFIG.replace(n_layers=7, d_model=64, n_heads=4, n_kv_heads=1,
                          head_dim=16, d_ff=128, vocab=256,
                          sliding_window=8, attn_chunk=32)
