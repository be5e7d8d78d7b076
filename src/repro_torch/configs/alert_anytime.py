"""The paper's own model family: a width-nested anytime LM (paper
Section 4), ``nest_levels=4`` (level widths d/8, d/4, d/2, d), about 160M
parameters at full width.  Same numbers as ``repro.configs.alert_anytime``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="alert-anytime-120m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=8,
    n_kv_heads=8,
    head_dim=96,
    d_ff=3072,
    vocab=32768,
    nest_levels=4,
)


def reduced() -> ModelConfig:
    """Same family shrunk for CPU tests."""
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
                          head_dim=8, d_ff=128, vocab=256, nest_levels=3,
                          attn_chunk=32)
