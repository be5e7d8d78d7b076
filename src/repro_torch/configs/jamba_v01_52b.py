"""jamba-v0.1-52b: hybrid, 32 layers, d_model 4096, 32 query heads over 8
KV heads of 128, vocab 65536; Mamba and attention interleaved 7:1 and a
MoE FFN (16 SwiGLU experts of d_ff 14336, top-2) every other layer
[arXiv:2403.19887; hf].  Same numbers as ``repro.configs.jamba_v01_52b``.

The layer period is 8: position 4 is attention, the other seven are Mamba
(d_inner 8192, d_state 16, d_conv 4, dt_rank 256); odd positions carry the
MoE FFN, even ones a dense SwiGLU.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    attn_offset=4,
    mamba_d_state=16,
    mamba_expand=2,
    mamba_d_conv=4,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests (8 layers: period 6 plus two)."""
    return CONFIG.replace(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=96, vocab=256, n_experts=4,
                          top_k=2, mamba_d_state=4, mamba_chunk=16,
                          attn_chunk=32)
