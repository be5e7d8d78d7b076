"""Serving engine: batched prefill + cached greedy decode, one program
per anytime level (port of ``repro.serving.engine``).

The reference compiles one prefill and one decode program per level and
counts their traces (``n_compiles``, the zero-recompile contract of
DESIGN.md §8).  Here each program is a *step*: a plain function over the
engine's own static buffers of one level (the prompt tokens, the next
token, ``cache_len`` as an int32 device scalar, and the KV caches at the
level's width, the Mamba states or the RWKV states):

* the prefill step runs ``lm_apply(mode="prefill")``, copies the prompt's
  k/v into the front of the static caches and zeroes their tail (the
  state a fresh ``init_caches`` gives; Mamba and RWKV states are replaced
  whole), writes the argmax into the next-token buffer and sets
  ``cache_len``;
* the decode step runs one decode forward at ``cache_len``, copies the
  new Mamba and RWKV states into the static ones, writes the argmax and
  adds one to ``cache_len``, all on the device.

On the card each step is captured once as a CUDA graph, per (level,
prompt length) for prefill and per level for decode, after one eager call
on a side stream (which builds and loads the kernels outside the
capture); every later call replays the graph.  On the CPU, or with
``graphs=False``, the same step functions run eagerly.  A capture that
fails raises.  The graphs read the weights of the ``params`` they were
captured with; a call with another ``params`` object captures anew.

With a flight recorder (``obs=``, or the process recorder while
``torch.profiler`` records), each ``generate`` is a ``generate`` span
holding an ``upload`` span (the prompt's copy to the card), one ``step``
span a prefill or decode call (on the card the host's time in
``graph.replay()``) and one ``token`` span a copy of the next token to
the host (which waits for the card); each capture counts in
``graph_captures`` and is a ``graph_capture`` event.  The recorder only
reads the clock around work the engine does anyway.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.nested_matmul import nested_matmul
from repro_torch.kernels.rwkv_scan import rwkv_scan
from repro_torch.models import transformer as tfm
from repro_torch.models.registry import Model
from repro_torch.obs import no_span, resolve_obs, span_recorder

# The kernel wrappers a step may call.  Each counts its launches in
# Python, which a graph replay does not run, so a replayed step adds what
# its capture counted: each wrapper's ``launches``, and
# ``nested_matmul.v4_launches`` (those of its launches that took v4).
COUNTED = (nested_matmul, flash_attention, decode_attention, rwkv_scan)
_COUNTERS = tuple((w, "launches") for w in COUNTED) + (
    (nested_matmul, "v4_launches"),)


@dataclasses.dataclass
class _Buffers:
    """The static buffers of one level."""

    caches: list                 # KV caches at the level's width / states
    cache_len: torch.Tensor      # int32, 0-d: the next decode position
    next_tok: torch.Tensor       # [B, 1] int64
    prompts: dict                # prompt length -> [B, S0] int64


class Step:
    """One step function; on the card, a CUDA graph of it.

    ``launches`` holds, per wrapper in :data:`COUNTED`, the launches one
    call makes on the card (what the capture counted), ``v4_launches``
    those of ``nested_matmul``'s that took v4; a replay adds them to the
    wrappers' counters.
    """

    def __init__(self, fn, device: torch.device, graph: bool):
        self.fn = fn
        self.graph = None
        self.launches = (0,) * len(COUNTED)
        self.v4_launches = 0
        if graph:
            self._capture(device)

    def _capture(self, device: torch.device) -> None:
        with torch.cuda.device(device):
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                self.fn()
            torch.cuda.current_stream(device).wait_stream(side)
            before = [getattr(w, a) for w, a in _COUNTERS]
            graph = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(graph):
                self.fn()
            counts = [getattr(w, a) - n
                      for (w, a), n in zip(_COUNTERS, before)]
            for (w, a), n in zip(_COUNTERS, before):
                setattr(w, a, n)     # the capture launched nothing
            self.launches = tuple(counts[:len(COUNTED)])
            self.v4_launches = counts[-1]
            graph.instantiate()
        self.graph = graph

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
            return
        self.graph.replay()
        for w, n in zip(COUNTED, self.launches):
            w.launches += n
        nested_matmul.v4_launches += self.v4_launches


@dataclasses.dataclass
class ServeEngine:
    """Per-level serving of one model on ``device`` (default ``"cuda"``):
    prefill, then greedy cached decode, each a step over static buffers,
    replayed from a CUDA graph on the card unless ``graphs`` is False.
    ``obs`` is a :class:`~repro_torch.obs.FlightRecorder` to record into
    (a fleet server hands over its own where this is None)."""

    model: Model
    max_len: int
    batch_size: int
    device: torch.device | str | None = None
    graphs: bool = True
    obs: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        cfg = self.model.cfg
        if cfg.encoder_layers:
            raise ValueError(f"{cfg.name}: the engine serves decoder-only "
                             f"LMs (lm_apply), not an encoder-decoder, as "
                             f"the reference's does")
        self.levels = list(range(1, cfg.nest_levels + 1)) \
            if cfg.nest_levels > 1 else [None]
        self._kv = any(cfg.mixer_kind(i) in ("attn", "attn_local")
                       for i in range(cfg.n_layers))
        self._params = None
        self._buffers: dict = {}
        self.steps: dict = {}       # ("prefill", level, S0) | ("decode", level)
        self._made = [0, 0]         # prefill, decode steps made

    def init_caches(self, level: int | None = None):
        """Fresh decode caches of ``level``: KV buffers sized to its KV
        width, and the Mamba or RWKV states."""
        from repro_torch.models.attention import head_stripe_specs

        cfg = self.model.cfg
        lvl = cfg.nest_levels if level is None else level
        _, _, kv_spec = head_stripe_specs(cfg)
        n_kv = kv_spec.width(lvl) // cfg.head_dim
        lvl_cfg = cfg.replace(n_kv_heads=max(n_kv, 1))
        return tfm.init_caches(lvl_cfg, self.batch_size, self.max_len,
                               device=self.device)

    def n_compiles(self) -> tuple[int, int]:
        """(prefill, decode) steps made, summed over levels: on the card
        the CUDA graphs captured.  After one warm-up per level and prompt
        length, switching levels between requests leaves both flat."""
        return tuple(self._made)

    def warmup(self, params, prompt_len: int) -> None:
        """Make every level's steps for ``prompt_len``-token prompts (on the
        card: capture their graphs), so no capture falls in a timed call."""
        ob = span_recorder(resolve_obs(self.obs))
        with torch.inference_mode():
            for lvl in self.levels:
                self._steps(params, self._level(lvl), prompt_len, ob)

    def generate(self, params, prompt: np.ndarray, n_new: int,
                 level: int | None = None,
                 deadline_s: float | None = None,
                 clock=None) -> dict:
        """Greedy-decode ``n_new`` tokens after ``prompt [B, S0]``.

        ``level`` None runs the deepest level (a model without nesting has
        no other).  A deadline (seconds on ``clock``, default
        ``time.perf_counter``) makes generate return the tokens complete at
        expiry.  Each step's token is copied to the
        host before the next clock read, which waits for the card, so
        deadline checks and the reported latency include the compute.
        """
        if clock is None:
            clock = time.perf_counter
        t0 = clock()
        lvl = self._level(level)
        s0 = prompt.shape[1]
        if prompt.shape[0] != self.batch_size:
            raise ValueError(f"prompt batch {prompt.shape[0]} != the "
                             f"engine's batch_size {self.batch_size}")
        if self._kv and s0 + n_new - 1 > self.max_len:
            raise ValueError(f"{s0} prompt tokens and {n_new} new ones "
                             f"overflow the {self.max_len}-slot KV cache")
        ob = span_recorder(resolve_obs(self.obs))
        span = ob.spans.span if ob is not None else no_span
        with span("generate", cat="engine", level=lvl, prompt_len=s0,
                  tokens_wanted=n_new) as args, torch.inference_mode():
            prefill, decode, buf = self._steps(params, lvl, s0, ob)
            with span("upload", cat="engine"):
                buf.prompts[s0].copy_(torch.as_tensor(np.asarray(prompt,
                                                                 np.int64)))
            with span("step", cat="engine", stage="prefill", level=lvl,
                      graphed=prefill.graph is not None):
                prefill()
            with span("token", cat="engine"):
                toks = [buf.next_tok.cpu().numpy().astype(np.int32)]
            for _ in range(n_new - 1):
                if deadline_s is not None and clock() - t0 > deadline_s:
                    break
                with span("step", cat="engine", stage="decode", level=lvl,
                          graphed=decode.graph is not None):
                    decode()
                with span("token", cat="engine"):
                    toks.append(buf.next_tok.cpu().numpy().astype(np.int32))
            if args is not None:
                args["tokens_made"] = len(toks)
        return {
            "tokens": np.concatenate(toks, axis=1),
            "latency": clock() - t0,
            "level": lvl,
            "complete": len(toks) == n_new,
        }

    def _level(self, level: int | None) -> int | None:
        cfg = self.model.cfg
        return level if level is not None or cfg.nest_levels == 1 \
            else cfg.nest_levels

    def _steps(self, params, lvl, s0: int, ob=None):
        """(prefill step, decode step, buffers) of level ``lvl`` for
        ``s0``-token prompts, made on first use; each capture counts in
        ``ob``, a resolved recorder or None."""
        if params is not self._params:
            self._params, self.steps = params, {}
        buf = self._buffers.get(lvl)
        if buf is None:
            dev = self.device
            buf = self._buffers[lvl] = _Buffers(
                self.init_caches(lvl),
                torch.zeros((), dtype=torch.int32, device=dev),
                torch.zeros((self.batch_size, 1), dtype=torch.int64,
                            device=dev), {})
        if s0 not in buf.prompts:
            buf.prompts[s0] = torch.zeros((self.batch_size, s0),
                                          dtype=torch.int64,
                                          device=self.device)
        graph = self.graphs and self.device.type == "cuda"
        key = ("prefill", lvl, s0)
        if key not in self.steps:
            self.steps[key] = Step(self._prefill_fn(params, lvl, buf, s0),
                                   self.device, graph)
            self._made[0] += 1
            self._count_capture(ob, self.steps[key], "prefill", lvl, s0)
        if ("decode", lvl) not in self.steps:
            self.steps["decode", lvl] = Step(
                self._decode_fn(params, lvl, buf), self.device, graph)
            self._made[1] += 1
            self._count_capture(ob, self.steps["decode", lvl], "decode",
                                lvl, s0)
        return self.steps[key], self.steps["decode", lvl], buf

    @staticmethod
    def _count_capture(ob, step: Step, stage: str, lvl, s0: int) -> None:
        """Count a step just made in ``ob`` where it captured a graph."""
        if ob is None or step.graph is None:
            return
        ob.metrics.counter("graph_captures").inc()
        ob.spans.event("graph_capture", cat="engine", stage=stage,
                       level=lvl, prompt_len=s0)

    def _prefill_fn(self, params, lvl, buf: _Buffers, s0: int):
        cfg = self.model.cfg

        def prefill():
            out = tfm.lm_apply(params, cfg, buf.prompts[s0],
                               mode="prefill", level=lvl)
            self._merge(buf.caches, out.caches)
            buf.next_tok.copy_(torch.argmax(out.logits[:, -1:], dim=-1))
            buf.cache_len.fill_(s0)
        return prefill

    def _decode_fn(self, params, lvl, buf: _Buffers):
        cfg = self.model.cfg

        def decode():
            out = tfm.lm_apply(params, cfg, buf.next_tok, mode="decode",
                               caches=buf.caches, cache_len=buf.cache_len,
                               level=lvl)
            self._merge(buf.caches, out.caches)
            buf.next_tok.copy_(torch.argmax(out.logits[:, -1:], dim=-1))
            buf.cache_len.add_(1)
        return decode

    @staticmethod
    def _merge(buffers, new):
        """Copy each layer's new cache leaves into ``buffers`` in place and
        return them: a leaf of the buffer's shape (a ``MambaState``'s SSM
        state and conv tail, an ``RwkvState``'s leaves) whole, a
        shorter prefill k/v into the front of its buffer with the tail
        zeroed; a leaf that is the buffer itself (a decode step's cache,
        written in place) is left as it is."""
        for buf, leaves in zip(buffers, new):
            for b, p in zip(buf, leaves):
                if p is b:
                    continue
                if p.shape == b.shape:
                    b.copy_(p)
                    continue
                n = p.shape[1]
                b[:, :n].copy_(p)
                b[:, n:].zero_()
        return buffers
