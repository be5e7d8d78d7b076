"""ModelConfig of the port: the fields of ``repro.configs.base.ModelConfig``
that the port's families read, with the same names and defaults.

The port runs every family of the reference's zoo: the width-nested
anytime LM (``family="dense"``, ``nest_levels >= 2``), the dense LMs
without nesting (``family="dense"``: stablelm, qwen2.5, gemma3 with its
sliding window), the mixture-of-experts LMs (``family="moe"``: olmoe,
qwen3-moe; as in the reference, ``n_experts > 0`` puts a MoE FFN at layers
``i % moe_every == moe_offset`` whatever the family), the hybrid family
(``family="hybrid"``: jamba, attention at layers ``i % attn_every ==
attn_offset`` and Mamba elsewhere), the vision-language family's decoder
(``family="vlm"``: qwen2-vl, M-RoPE over ``pos3d`` position streams), the
RWKV-6 family (``family="ssm"``, ``rwkv=True``) and the encoder-decoder
(whisper).  As in the reference, ``encoder_layers > 0`` makes a model an
encoder-decoder whatever its family (``build_model`` dispatches on it),
and ``family="encdec"`` with ``encoder_layers == 0`` is a decoder-only
LM.  ``norm_kind`` is declared, as the reference declares it, and read by
no module: every norm is RMSNorm on both sides.
"""

from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 1e4
    qkv_bias: bool = False
    m_rope: bool = False
    mrope_sections: tuple[int, int, int] = (16, 24, 24)
    sliding_window: int | None = None    # window size for local layers
    global_every: int = 0                # gemma3: layer i is global iff
    #                         (i+1) % global_every == 0; 0 = all global
    attn_logit_softcap: float | None = None
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                   # MoE FFN at layers i % moe_every
    moe_offset: int = 0                  #   == moe_offset
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01      # the MoE aux loss's weight in
    #                                      the training loss
    attn_every: int = 0                  # hybrid: attention at layers
    attn_offset: int = 4                 #   i % attn_every == attn_offset,
    #                                      Mamba elsewhere; 0 = all attention
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    mamba_dt_rank: int = 0               # 0 -> ceil(d_model / 16)
    mamba_chunk: int = 128
    rwkv: bool = False                   # RWKV-6 mixer in every layer
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    rwkv_chunk: int = 128                # a train forward's recurrence:
    #                                      tokens a recomputed chunk
    encoder_layers: int = 0              # 0 = decoder-only
    nest_levels: int = 1                 # width nesting; 1 = off
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    norm_kind: str = "rmsnorm"           # declared; no module reads it
    tie_embeddings: bool = False
    attn_chunk: int = 1024               # query chunk of prefill attention
    attn_backend: str = "ref"            # ref | kernel
    window_banded: bool = False          # sliding-window prefill reads only
    #                                      the key band, not the full sequence
    prefill_last_only: bool = False
    nest_backend: str = "blocks"         # blocks | masked | kernel
    moe_dispatch: str = "onehot"         # onehot (GShard) | gather (sorted
    #                                      index dispatch)
    remat: bool = True                   # training recomputes each layer
    #                                      in the backward pass
    remat_policy: str = "full"           # full | save_dots (keep matmul
    #                                      outputs, recompute the rest)
    loss_chunk: int = 0                  # 0 = unchunked cross-entropy

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.n_experts and not self.top_k:
            raise ValueError("MoE config needs top_k")
        if self.n_experts and self.nest_levels != 1:
            raise ValueError("the port runs MoE models without width "
                             "nesting (nest_levels == 1)")
        if self.attn_every and self.nest_levels != 1:
            raise ValueError("the port runs hybrid models without width "
                             "nesting (nest_levels == 1)")
        if self.moe_dispatch not in ("onehot", "gather"):
            raise ValueError(f"moe_dispatch must be 'onehot' or 'gather', "
                             f"not {self.moe_dispatch!r}")
        if self.nest_levels < 1:
            raise ValueError(f"nest_levels {self.nest_levels} < 1")
        if self.rwkv:
            if self.nest_levels != 1:
                raise ValueError("the port runs RWKV models without width "
                                 "nesting (nest_levels == 1)")
            if self.d_model % self.rwkv_head_dim:
                raise ValueError("d_model must divide into rwkv heads")
        if self.attn_backend not in ("ref", "kernel"):
            raise ValueError(f"attn_backend must be 'ref' or 'kernel', not "
                             f"{self.attn_backend!r}")
        if self.remat_policy not in ("full", "save_dots"):
            raise ValueError(f"remat_policy must be 'full' or 'save_dots', "
                             f"not {self.remat_policy!r}")

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def mamba_dt_rank_actual(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def mixer_kind(self, layer: int) -> str:
        """Which sequence mixer layer ``layer`` (0-based) uses: ``rwkv``
        first, then the hybrid's ``attn_every``, then gemma3's
        ``global_every``, as the reference decides."""
        if self.rwkv:
            return "rwkv"
        if self.attn_every:
            if layer % self.attn_every == self.attn_offset % self.attn_every:
                return "attn"
            return "mamba"
        if self.global_every:
            return "attn" if (layer + 1) % self.global_every == 0 \
                else "attn_local"
        return "attn"

    def ffn_kind(self, layer: int) -> str:
        """The feed-forward kind of layer ``layer``: ``"moe"`` or
        ``"dense"``."""
        if self.n_experts and layer % self.moe_every == self.moe_offset:
            return "moe"
        return "dense"

    def layer_plan(self) -> list[tuple[str, str]]:
        return [(self.mixer_kind(i), self.ffn_kind(i))
                for i in range(self.n_layers)]

    def layer_period(self) -> int:
        """Smallest repeating period of the layer plan (the reference's
        scan grouping)."""
        plan = self.layer_plan()
        for p in range(1, self.n_layers + 1):
            if all(plan[i] == plan[i % p] for i in range(self.n_layers)):
                return p
        return self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once), as the
        reference counts it: an RWKV layer counts a 3 * d * d_ff FFN, a
        MoE layer its router and ``n_experts`` SwiGLU experts, a tied model
        no unembedding.  A Mamba layer counts ``2 * d_inner`` vectors
        (``dt_bias`` and ``d_skip``) where its tensors hold three: like the
        reference, this count leaves out ``conv_b``, ``d_inner`` parameters
        a Mamba layer.  An encoder-decoder adds its encoder layers (a
        norm, attention and a SwiGLU each, no biases counted), each decoder
        layer's cross-attention (a norm and four matrices) and the
        encoder's final norm to the decoder's count, as the reference
        does."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d + d           # embed, final norm
        if not self.tie_embeddings:
            total += d * self.vocab          # unembed
        for mixer, ffn in self.layer_plan():
            total += 2 * d                    # two pre-norms
            if mixer == "rwkv":
                total += 5 * d + 5 * d * d + 2 * d * self.rwkv_decay_lora \
                    + 3 * d
            elif mixer == "mamba":
                di, ds = self.mamba_d_inner, self.mamba_d_state
                dt = self.mamba_dt_rank_actual
                total += d * 2 * di + self.mamba_d_conv * di \
                    + di * (dt + 2 * ds) + dt * di + di * ds + 2 * di \
                    + di * d
            else:
                total += 2 * d * self.n_heads * hd \
                    + 2 * d * self.n_kv_heads * hd
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            if ffn == "dense":
                total += 3 * d * self.d_ff
            else:                             # router, experts
                total += d * self.n_experts \
                    + self.n_experts * 3 * d * self.d_ff
        if self.encoder_layers:
            attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
            enc = self.encoder_layers * (2 * d + attn + 3 * d * self.d_ff)
            cross = self.n_layers * (d + attn)        # a norm and 4 matrices
            total += enc + cross + d                  # + encoder final norm
        return total

    def active_param_count(self) -> int:
        """MoE: the parameters one token touches (``top_k`` experts a MoE
        layer)."""
        total = self.param_count()
        for _, ffn in self.layer_plan():
            if ffn == "moe":
                total -= (self.n_experts - self.top_k) * 3 * self.d_model \
                    * self.d_ff
        return total

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
