"""ModelConfig of the port: the fields of ``repro.configs.base.ModelConfig``
that the port's families read, and those it refuses, with the same names
and defaults.

The port runs four kinds of model: the width-nested anytime LM
(``family="dense"``, ``nest_levels >= 2``), the dense LMs without nesting
(``family="dense"``: stablelm, qwen2.5, gemma3 with its sliding window),
the mixture-of-experts LMs (``family="moe"``: olmoe, qwen3-moe; as in the
reference, ``n_experts > 0`` puts a MoE FFN at layers ``i % moe_every ==
moe_offset`` whatever the family) and the RWKV-6 family (``family="ssm"``,
``rwkv=True``).  A config that asks for anything still unported, a family
or a field, raises a ``ValueError`` naming the ROADMAP item that ports
it: this is the one place that knows what the port does not run yet.
"""

from __future__ import annotations

import dataclasses

FAMILIES = ("dense", "moe", "hybrid", "ssm", "encdec", "vlm")

# The reference's families the port does not run yet, with the ROADMAP
# item (queue A3) that ports each.
UNPORTED_FAMILIES = {"hybrid": "A3.4 (hybrid)",
                     "encdec": "A3.5 (whisper encoder-decoder)",
                     "vlm": "A3.5 (qwen2-vl)"}

# Fields the port does not run yet, each with the value that turns it off
# and the ROADMAP item (queue A3) that ports it.
UNPORTED = (
    ("attn_every", 0, "A3.4 (hybrid: Mamba layers)"),
    ("encoder_layers", 0, "A3.5 (whisper encoder-decoder)"),
    ("m_rope", False, "A3.5 (qwen2-vl M-RoPE)"),
    ("norm_kind", "rmsnorm", "A3.5 (whisper LayerNorm)"),
    ("tie_embeddings", False, "A3.1 (left: tied embeddings)"),
    ("prefill_last_only", False, "A3.1 (left: last-position prefill)"),
)


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
    sliding_window: int | None = None    # window size for local layers
    global_every: int = 0                # gemma3: layer i is global iff
    #                         (i+1) % global_every == 0; 0 = all global
    attn_logit_softcap: float | None = None
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1                   # MoE FFN at layers i % moe_every
    moe_offset: int = 0                  #   == moe_offset
    capacity_factor: float = 1.25
    attn_every: int = 0
    rwkv: bool = False                   # RWKV-6 mixer in every layer
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64
    encoder_layers: int = 0
    nest_levels: int = 1                 # width nesting; 1 = off
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    norm_kind: str = "rmsnorm"
    tie_embeddings: bool = False
    attn_chunk: int = 1024               # query chunk of prefill attention
    attn_backend: str = "ref"            # ref | kernel
    window_banded: bool = False          # sliding-window prefill reads only
    #                                      the key band, not the full sequence
    prefill_last_only: bool = False
    nest_backend: str = "blocks"         # blocks | masked | kernel
    moe_dispatch: str = "onehot"         # onehot (GShard) | gather (sorted
    #                                      index dispatch)

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family in UNPORTED_FAMILIES:
            raise ValueError(f"{self.name}: family {self.family!r} is not "
                             f"ported yet (ROADMAP "
                             f"{UNPORTED_FAMILIES[self.family]})")
        for field, off, item in UNPORTED:
            value = getattr(self, field)
            if value != off:
                raise ValueError(f"{self.name}: {field}={value!r} is not "
                                 f"ported yet (ROADMAP {item})")
        if self.n_experts and not self.top_k:
            raise ValueError("MoE config needs top_k")
        if self.n_experts and self.nest_levels != 1:
            raise ValueError("the port runs MoE models without width "
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

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def mixer_kind(self, layer: int) -> str:
        """Which sequence mixer layer ``layer`` (0-based) uses."""
        if self.rwkv:
            return "rwkv"
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
        MoE layer its router and ``n_experts`` SwiGLU experts."""
        d, hd = self.d_model, self.head_dim
        total = 2 * self.vocab * d + d       # embed, unembed, final norm
        for mixer, ffn in self.layer_plan():
            total += 2 * d                    # two pre-norms
            if mixer == "rwkv":
                total += 5 * d + 5 * d * d + 2 * d * self.rwkv_decay_lora \
                    + 3 * d
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
