"""qwen3-moe-30b-a3b: mixture of experts, 48 layers, d_model 2048, 32
query heads over 4 KV heads of 128 (GQA, 8 query heads a KV head; 32 * 128
= 4096 != d_model, as in the released config), 128 SwiGLU experts of d_ff
768 with top-8 routing in every layer, vocab 151936, RoPE theta 1e6
[hf:Qwen/Qwen3-30B-A3B].  Same numbers as
``repro.configs.qwen3_moe_30b_a3b``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    rope_theta=1e6,
    n_experts=128,
    top_k=8,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=32, vocab=256, n_experts=8,
                          top_k=2, attn_chunk=32)
