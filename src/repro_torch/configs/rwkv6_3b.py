"""rwkv6-3b: RWKV-6 "Finch" (arXiv:2404.05892), 32 layers, d_model 2560,
40 heads of 64, d_ff 8960, vocab 65536; attention-free, with a
data-dependent per-channel decay.  Same numbers as
``repro.configs.rwkv6_3b``.

``n_heads``/``n_kv_heads``/``head_dim`` are informational (the mixer uses
``rwkv_n_heads`` heads of ``rwkv_head_dim``).  ``ModelConfig`` of the
reference reports 3.60e9 parameters from ``param_count()``, which counts a
3 * d * d_ff FFN; the tensors this family allocates hold about 3.07e9.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab=65536,
    rwkv=True,
    rwkv_head_dim=64,
    rwkv_decay_lora=64,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                          head_dim=32, d_ff=128, vocab=256,
                          rwkv_head_dim=32, rwkv_decay_lora=8,
                          rwkv_chunk=16, attn_chunk=32)
