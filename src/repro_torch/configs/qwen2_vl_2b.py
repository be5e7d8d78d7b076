"""qwen2-vl-2b: the language model of a vision-language model, 28 layers,
d_model 1536, 12 query heads over 2 KV heads of 128 with q/k/v biases,
d_ff 8960, vocab 151936, ``rope_theta`` 1e6 and M-RoPE with (temporal,
height, width) sections (16, 24, 24) [arXiv:2409.12191; hf].  Same
numbers as ``repro.configs.qwen2_vl_2b``.

The vision frontend is not part of the model, as in the reference: a
caller passes precomputed patch embeddings (``embeds``) and the 3-D
position ids (``pos3d [3, B, S]``); text tokens have three equal streams,
where M-RoPE equals RoPE.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    rope_theta=1e6,
    qkv_bias=True,
    m_rope=True,
    mrope_sections=(16, 24, 24),
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab=256,
                          mrope_sections=(2, 3, 3), attn_chunk=32)
