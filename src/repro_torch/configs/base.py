"""ModelConfig of the port: the fields the dense width-nested LM and the
RWKV-6 family read (a subset of ``repro.configs.base.ModelConfig``, same
names and defaults; embeddings are untied)."""

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
    attn_logit_softcap: float | None = None
    rwkv: bool = False                   # RWKV-6 mixer in every layer
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    nest_levels: int = 1                 # width nesting; 1 = off
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    attn_chunk: int = 1024               # query chunk of prefill attention
    attn_backend: str = "ref"            # ref | kernel
    nest_backend: str = "blocks"         # blocks | masked | kernel

    def __post_init__(self):
        if self.rwkv:
            if self.nest_levels != 1:
                raise ValueError("the port runs RWKV models without width "
                                 "nesting (nest_levels == 1)")
            if self.d_model % self.rwkv_head_dim:
                raise ValueError("d_model must divide into rwkv heads")
        elif self.nest_levels < 2:
            raise ValueError("the port runs width-nested models "
                             "(nest_levels >= 2) and RWKV models only")
        if self.attn_backend not in ("ref", "kernel"):
            raise ValueError(f"attn_backend must be 'ref' or 'kernel', not "
                             f"{self.attn_backend!r}")

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def mixer_kind(self, layer: int) -> str:
        """Which sequence mixer layer ``layer`` (0-based) uses."""
        return "rwkv" if self.rwkv else "attn"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
