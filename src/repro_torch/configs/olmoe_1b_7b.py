"""olmoe-1b-7b: mixture of experts, 16 layers, d_model 2048, 16 query
heads over 16 KV heads of 128 (MHA), 64 SwiGLU experts of d_ff 1024 with
top-8 routing in every layer, vocab 50304 [arXiv:2409.02060; hf].  Same
numbers as ``repro.configs.olmoe_1b_7b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                          head_dim=16, d_ff=32, vocab=256, n_experts=8,
                          top_k=2, attn_chunk=32)
