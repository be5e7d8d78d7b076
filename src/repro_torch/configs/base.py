"""ModelConfig of the port: the fields the dense width-nested LM reads
(a subset of ``repro.configs.base.ModelConfig``, same names and
defaults; embeddings are untied)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 1e4
    nest_levels: int = 1                 # width nesting; 1 = off
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    attn_chunk: int = 1024               # query chunk of prefill attention
    nest_backend: str = "blocks"         # blocks | masked

    def __post_init__(self):
        if self.nest_levels < 2:
            raise ValueError("the port runs width-nested models "
                             "(nest_levels >= 2) only")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
