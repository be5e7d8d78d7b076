"""Multi-pod dry run of the data plane (port of ``repro.launch.dryrun``):
count every (arch x shape x grid) cell on ``meta``.

For each cell this module:
  1. builds the production grid (16x16 single-pod or 2x16x16 multi-pod)
     with ``make_production_mesh(device="meta")``, nothing placed,
  2. builds the state (or params) with ``model.init(device="meta")`` and
     the batch and caches of the shape as ``meta`` tensors,
  3. runs the same step the reference lowers (``make_train_step`` with
     ``AdamW(lr=3e-4)`` for ``train``, ``model.prefill``, or
     ``model.decode_step`` over ``init_caches``) at the shape's global
     sizes on the plain paths, under :class:`StepCounter`, a
     ``TorchDispatchMode`` that tallies every aten op, and
  4. writes the record the reference writes, which
     :func:`repro_torch.launch.roofline.analyze` reads.

Where the reference compiles, the port counts.  What the count covers:

* **FLOPs.** A product (``mm``, ``addmm``, ``bmm``, ``baddbmm``) counts
  ``2*M*N*K`` (times its batch); a view, a copy or a fill (``clone``,
  ``cat``, ``index``, ``gather``, ``scatter``, ``zeros``, ...) none;
  every other op one FLOP per element of its largest operand (its output
  for an elementwise op, its input for a reduction).  XLA's
  ``cost_analysis`` counts the fused, partitioned HLO: it leaves out the
  transcendentals (counted apart there), counts a fused chain's
  elementwise ops on one pass, and counts the ops SPMD partitioning adds;
  so the two agree on the products and differ on the rest
  (``tests/test_torch_dryrun.py`` states by how much at reduced sizes).
* **Bytes accessed.** Each counted op's input plus output bytes: an
  unfused count, where XLA counts a fusion's operands and results once.
* **Per device.** Each tensor carries a placement: the inputs get the
  rules of :mod:`repro_torch.launch.shardings` (params and AdamW moments,
  batch, caches), and every op's outputs get one from its inputs (an
  elementwise op keeps its inputs' splits, a reshape carries each split
  to the dimension it lands in, a product keeps its operands' free and
  batch splits).  An op costs each device its share, by
  :func:`~repro_torch.launch.mesh.shard_shape` of its operands; work the
  rules leave replicated costs each device the whole amount.
* **Collectives**, reckoned from the same placements, with the ring
  formulas of the reference's ``collective_bytes``: an all-reduce over
  ``model`` of each product whose contracting dimension is split (the
  row-parallel projections, and in the backward the input gradients of
  the column-parallel ones), and of each reduction or softmax over a
  split dimension; an all-gather of an operand whose split two operands
  claim for different dimensions; the data axes' gradient reduction of
  each parameter leaf after the backward pass (a reduce-scatter where the
  rules split the leaf over a data axis, else an all-reduce; products and
  reductions over the data axes inside the backward pass are its partial
  sums and add nothing of their own).  Under these rules a MoE layer's
  tokens are replicated over ``model``, so its dispatch is a local slice
  of each device's experts and its return the all-reduce over ``model``
  of the combine product, as XLA partitions the reference (no all-to-all
  in its counts at reduced size).
* **Memory.** ``argument_size`` sums the per-device shard bytes of the
  step's inputs (state or params, batch, caches) by the rules,
  ``output_size`` those of its outputs (the new state and the decode
  caches by the rules, the rest as placed by the count), ``temp_size`` is
  the peak per-device bytes of the intermediates alive at once.

Recurrences and depth.  The port's forward loops over its layers in
Python, so every count is the unrolled one (the reference's
``unroll_layers`` and ``attn_unroll_chunks`` have no counterpart and are
left out).  Its time loops are not traced token by token: while a step
is counted, :func:`scans_counted_once` swaps ``mamba._ssm_scan``,
``rwkv._wkv_chunk_scan`` and ``rwkv.rwkv_scan`` for versions that run
the port's own recurrence on one token a chunk and stand that token's
output in for the chunk's, so the body is counted once a chunk, as XLA
counts a ``while`` body once.  :func:`calibrate` counts the 1-period and
2-period configs with ``mamba_chunk = rwkv_chunk = seq`` (one chunk, so
the mixers take their one-chunk path) and composes them into the whole
depth, adding :func:`_recurrence_flops`, as the reference does.

Keys with no counterpart: ``lower_s`` is the seconds to build the step's
inputs on ``meta``, ``compile_s`` the seconds of the count;
``memory.generated_code_size`` and ``hlo_bytes`` are ``None`` (there is
no compiled program and no HLO).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k --mesh single --out artifacts/dryrun
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
import weakref
from contextlib import contextmanager, nullcontext

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import configs
from repro_torch.configs.shapes import (SHAPES, ShapeSpec, cell_supported,
                                        input_specs)
from repro_torch.launch import shardings as sh
from repro_torch.launch.mesh import (GridMesh, batch_axes,
                                     make_production_mesh, shard_shape)
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train.step import TrainState, make_train_step
from repro_torch.tree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

aten = torch.ops.aten
# product -> (batched, position of its first operand)
_PRODUCTS = {aten.mm.default: (False, 0), aten.addmm.default: (False, 1),
             aten.bmm.default: (True, 0), aten.baddbmm.default: (True, 1)}
# Ops that move, copy or fill and compute nothing.
_MOVES = {
    "clone", "copy", "copy_", "cat", "stack", "index", "_unsafe_index",
    "index_select", "gather", "scatter", "index_put", "index_put_",
    "_index_put_impl_", "index_copy", "index_copy_", "slice_scatter",
    "select_scatter", "slice_backward", "select_backward",
    "constant_pad_nd", "repeat", "flip", "roll", "embedding", "zeros",
    "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
    "full_like", "new_full", "fill", "fill_", "zero_", "arange",
    "scalar_tensor", "lift_fresh", "lift_fresh_copy", "masked_scatter"}
# Allocations that write nothing.
_EMPTIES = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided"}
# Reductions: (position of ``dim``, position of ``keepdim``).
_REDUCTIONS = {"sum": (1, 2), "mean": (1, 2), "amax": (1, 2),
               "amin": (1, 2), "max": (1, 2), "min": (1, 2),
               "argmax": (1, 2), "argmin": (1, 2), "logsumexp": (1, 2),
               "prod": (1, 2), "any": (1, 2), "all": (1, 2),
               "var": (1, None), "std": (1, None), "var_mean": (1, None),
               "linalg_vector_norm": (2, 3), "count_nonzero": (1, None)}
# Ops with a reduction along ``dim`` inside (output shaped as the input):
# op -> (position of ``dim``, statistics all-reduced when it is split).
_ALONG = {"_softmax": (1, 2), "_log_softmax": (1, 2),
          "_softmax_backward_data": (2, 1),
          "_log_softmax_backward_data": (2, 1)}
# Ops that only reinterpret their input's elements.
_VIEWLIKE = {"_unsafe_view", "view_copy", "_reshape_alias",
             "_reshape_copy"}
_HOST_COPIES = {"_to_copy", "copy_", "lift_fresh", "lift_fresh_copy"}


# --------------------------------------------------------------------- #
# Placements of counted tensors                                          #
# --------------------------------------------------------------------- #
# A placement is a tuple with an entry a dimension; an entry is a tuple of
# parts ``(size, axes)``, major first, whose sizes multiply to the
# dimension's: a reshape that merges dimensions keeps each one's split in
# its part, so a later reshape can give it back.
def _replicated(shape) -> tuple:
    return tuple(((int(n), ()),) for n in shape)


def _dim_axes(dim) -> tuple:
    return tuple(a for _, axes in dim for a in axes)


def _dedupe(spec) -> tuple:
    """Each mesh axis splits at most one dimension: a later claim on an
    axis is dropped."""
    seen, out = set(), []
    for dim in spec:
        parts = []
        for size, axes in dim:
            keep = tuple(a for a in axes if a not in seen)
            seen.update(keep)
            parts.append((size, keep))
        out.append(tuple(parts))
    return tuple(out)


def _cut(dim, size: int, factor) -> tuple:
    """``dim`` cut to ``size`` elements (a slice): one part, split as
    before where the factor still divides it."""
    axes = _dim_axes(dim)
    if axes and size % factor(axes):
        axes = ()
    return ((int(size), axes),)


class _Unresolved(Exception):
    pass


def _reshape(spec, shape_out, factor) -> tuple:
    """Carry each split through a reshape: the input's parts, in order,
    are regrouped into the output's dimensions; a part cut in two keeps
    its split on the major piece (padded where it does not divide, as
    :func:`~repro_torch.launch.mesh.shard_shape` pads), or on the minor
    one where the major has fewer elements than shards and the minor
    divides."""
    atoms = [p for dim in spec for p in dim if p[0] != 1]
    out, i = [], 0
    for n in shape_out:
        n = int(n)
        parts, need = [], n
        while need > 1:
            if i >= len(atoms):
                raise _Unresolved
            size, axes = atoms[i]
            if need % size == 0:
                parts.append((size, axes))
                need //= size
                i += 1
            elif size % need == 0:
                rest = size // need
                f = factor(axes)
                major = not axes or need >= f or rest % f
                parts.append((need, axes if major else ()))
                atoms[i] = (rest, () if major else axes)
                need = 1
            else:
                raise _Unresolved
        out.append(tuple(parts) or ((1, ()),))
    if i < len(atoms):
        raise _Unresolved
    return tuple(out)


def _broadcast(shape_out, ins) -> tuple:
    """An elementwise result's placement: each dimension split as the
    first input (aligned from the right, of the same size) that splits
    it."""
    nd = len(shape_out)
    out = []
    for j, n in enumerate(shape_out):
        chosen = None
        for spec, shape in ins:
            k = j - (nd - len(shape))
            if k >= 0 and shape[k] == n and _dim_axes(spec[k]):
                chosen = spec[k]
                break
        out.append(chosen or ((int(n), ()),))
    return _dedupe(out)


def _tensors(x, found: list) -> list:
    """The tensors in ``x`` (nested tuples and lists), in order."""
    if isinstance(x, torch.Tensor):
        found.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, found)
    return found


def _dims(arg, ndim: int) -> list[int]:
    """A ``dim`` argument as a sorted list of non-negative dims (all of
    them for ``None`` or ``[]``)."""
    if arg is None:
        return list(range(ndim))
    if isinstance(arg, int):
        arg = [arg]
    dims = sorted({d % ndim for d in arg}) if ndim else []
    return dims or list(range(ndim))


# --------------------------------------------------------------------- #
# The counter                                                            #
# --------------------------------------------------------------------- #
class _Effects:
    """One op's effect on a count (see :meth:`StepCounter._effects`)."""

    __slots__ = ("out_specs", "flops", "bytes", "fresh", "view",
                 "collectives", "product_flops")

    def __init__(self, out_specs, flops, nbytes, fresh, view=False):
        self.out_specs, self.flops, self.bytes = out_specs, flops, nbytes
        self.fresh, self.view = fresh, view
        self.collectives, self.product_flops = [], 0


# An op's effects depend only on its arguments' shapes, dtypes and
# placements (and the grid), so every layer after the first finds its
# ops here.
_EFFECTS: dict = {}
_EFFECTS_MAX = 500_000


class StepCounter(TorchDispatchMode):
    """Tallies every aten op run under it on ``device`` (``meta`` or a
    real device) as one device of ``mesh`` would run it: FLOPs, bytes,
    collectives, peak live intermediates (module docstring).

    Register the step's inputs with :meth:`place` before running it.
    ``seq_shard`` (the ``opt_sp`` variant) splits every residual-stream
    activation ``[B, S, d_model]`` along the sequence over ``model``.
    Copies of constants from the host (a ``_to_copy`` of a CPU tensor
    the step did not make) are not counted, so a cached constant counts
    the same as a fresh one, on any device."""

    def __init__(self, mesh: GridMesh, device, seq_shard=None):
        super().__init__()
        self.mesh = mesh
        self.device = torch.device(device)
        self.sizes = dict(zip(mesh.axis_names, mesh.shape))
        self.dp = batch_axes(mesh)
        self.seq_shard = seq_shard        # (B, S, d) or None
        self.specs = WeakIdKeyDictionary()
        self.flops = 0
        self.bytes = 0
        self.product_flops = 0            # global 2*M*N*K, all devices
        self.coll = {c: 0 for c in COLLECTIVES}
        self.traffic = {c: 0 for c in COLLECTIVES}
        self.counts = {c: 0 for c in COLLECTIVES}
        self.by_op: dict[str, list[int]] = {}
        self.live = 0
        self.peak = 0
        self._recording = None
        self._context = (mesh.shape, mesh.axis_names, seq_shard)

    # -- placements -------------------------------------------------- #
    def factor(self, axes) -> int:
        return math.prod(self.sizes[a] for a in axes)

    def place(self, tensor: torch.Tensor, pspec) -> None:
        """Register an input with a partition spec of the rules."""
        spec = []
        for j, n in enumerate(tensor.shape):
            e = pspec[j] if j < len(pspec) else None
            axes = () if e is None else ((e,) if isinstance(e, str)
                                         else tuple(e))
            spec.append(((int(n), axes if n > 1 else ()),))
        self.specs[tensor] = tuple(spec)

    def spec(self, t: torch.Tensor) -> tuple:
        s = self.specs.get(t)
        if s is None or len(s) != t.dim():
            s = _replicated(t.shape)
        return s

    def local_numel(self, spec) -> int:
        return math.prod(-(-size // self.factor(axes))
                         for dim in spec for size, axes in dim)

    def local_bytes(self, t: torch.Tensor, spec=None) -> int:
        return self.local_numel(self.spec(t) if spec is None else spec) \
            * t.element_size()

    # -- collectives ------------------------------------------------- #
    def collective(self, kind: str, nbytes: int, axes) -> None:
        """One collective over ``axes`` of ``nbytes`` per device (the
        operand: for an all-gather the block before it, for a
        reduce-scatter the whole before it)."""
        g = self.factor(axes)
        if g <= 1 or nbytes <= 0:
            return
        if self._recording is not None:
            self._recording.append((kind, nbytes, tuple(axes)))
            return
        if kind == "all-reduce":
            tr = 2 * nbytes * (g - 1) // g
        elif kind == "all-gather":
            tr = nbytes * g * (g - 1) // g
        elif kind == "reduce-scatter":
            tr = nbytes * (g - 1) // g
        else:
            tr = nbytes
        self.coll[kind] += int(nbytes)
        self.traffic[kind] += int(tr)
        self.counts[kind] += 1

    def reduce_axes(self, axes) -> tuple:
        """The axes a reduction over ``axes`` all-reduces: inside the
        backward pass the data axes' partial sums are the gradients',
        reduced once a leaf (:meth:`gradient_reduction`)."""
        axes = tuple(dict.fromkeys(axes))
        if torch._C._current_autograd_node() is not None:
            axes = tuple(a for a in axes if a not in self.dp)
        return axes

    def gradient_reduction(self, leaf: torch.Tensor, pspec) -> None:
        """The data axes' reduction of one leaf's gradient (the leaf's
        dtype, as ``make_train_step`` keeps it with one microbatch)."""
        nbytes = math.prod(shard_shape(pspec, self.mesh, leaf.shape)) \
            * leaf.element_size()
        named = {a for e in pspec if e is not None
                 for a in ((e,) if isinstance(e, str) else e)}
        split = [a for a in self.dp if a in named]
        if split:
            self.collective("reduce-scatter",
                            nbytes * self.factor(split), self.dp)
        else:
            self.collective("all-reduce", nbytes, self.dp)

    # -- the op rules ------------------------------------------------- #
    def _product(self, func, args, out):
        batched, apos = _PRODUCTS[func]
        a, b = args[apos], args[apos + 1]
        sa, sb = self.spec(a), self.spec(b)
        if not batched:
            (ma, ka), (kb, nb) = sa, sb
            ba = bb = None
        else:
            (ba, ma, ka), (bb, kb, nb) = sa, sb
        best = None
        # Where the operands claim one axis for two dimensions, the split
        # of the larger operand holds and the smaller one is gathered.
        for m_first in (True, False):
            plan = self._product_plan(a, b, sa, sb, ba, bb, ma, ka, kb, nb,
                                      m_first)
            if best is None or plan[0] < best[0]:
                best = plan
        _, out_spec, k_axes, gathers = best
        for t, s, lost in gathers:
            self.collective("all-gather", self.local_bytes(t, s), lost)
        k = int(a.shape[-1])
        m_loc = self.local_numel(out_spec)
        flops = 2 * m_loc * -(-k // self.factor(k_axes))
        self._product_flops = 2 * out.numel() * k
        red = self.reduce_axes(k_axes)
        if red:
            self.collective("all-reduce", m_loc * out.element_size(), red)
        return [out_spec], flops

    def _product_plan(self, a, b, sa, sb, ba, bb, ma, ka, kb, nb, m_first):
        """The output placement, contracting axes and gathers of a
        product, the free dims deduped M first or N first; the first item
        is the bytes gathered."""
        batch = [] if ba is None else [ba if _dim_axes(ba) else bb]
        if m_first:
            out_spec = _dedupe(batch + [ma, nb])
        else:
            rev = _dedupe(batch + [nb, ma])
            out_spec = rev[:len(batch)] + (rev[-1], rev[-2])
        used = {x for d in out_spec for x in _dim_axes(d)}
        k_axes = tuple(x for x in dict.fromkeys(_dim_axes(ka) +
                                                _dim_axes(kb))
                       if x not in used)
        kept_b = _dim_axes(out_spec[0]) if batch else ()
        kept_m, kept_n = _dim_axes(out_spec[-2]), _dim_axes(out_spec[-1])
        gathers, cost = [], 0
        for t, s, roles in ((a, sa, ((ba, kept_b), (ma, kept_m),
                                     (ka, k_axes))),
                            (b, sb, ((bb, kept_b), (kb, k_axes),
                                     (nb, kept_n)))):
            lost = tuple(dict.fromkeys(
                x for d, kept in roles if d is not None
                for x in _dim_axes(d) if x not in kept))
            if lost:
                gathers.append((t, s, lost))
                cost += self.local_bytes(t, s)
        return cost, out_spec, k_axes, gathers

    def _reduction(self, name, args, kwargs, outs, ins_specs):
        x, sx = args[0], ins_specs[0]
        dpos, kpos = _REDUCTIONS[name]
        dim = kwargs.get("dim", args[dpos] if len(args) > dpos else None)
        keep = kwargs.get("keepdim", args[kpos] if kpos is not None and
                          len(args) > kpos else False)
        if isinstance(dim, bool):         # var(self, unbiased)
            dim = None
        dims = _dims(dim, x.dim())
        spec = []
        for j, dj in enumerate(sx):
            if j in dims:
                if keep:
                    spec.append(((1, ()),))
            else:
                spec.append(dj)
        axes = [a for j in dims for a in _dim_axes(sx[j])]
        out_specs = [tuple(spec) if len(spec) == o.dim()
                     else _replicated(o.shape) for o in outs]
        red = self.reduce_axes(axes)
        if red and outs:
            self.collective("all-reduce", self.local_bytes(
                outs[0], out_specs[0]), red)
        return out_specs, self.local_numel(sx)

    def _along(self, name, args, outs, ins_specs):
        dpos, n_stats = _ALONG[name]
        x, sx = outs[0], ins_specs[0]
        out_spec = _broadcast(x.shape, [(s, t.shape) for s, t in
                                        zip(ins_specs, args)
                                        if isinstance(t, torch.Tensor)])
        d = args[dpos] % x.dim()
        red = self.reduce_axes(_dim_axes(out_spec[d]))
        if red:
            stat = list(out_spec)
            stat[d] = ((1, ()),)
            for _ in range(n_stats):
                self.collective("all-reduce", self.local_numel(stat) * 4,
                                red)
        return [out_spec], self.local_numel(out_spec)

    def _view(self, name, args, kwargs, outs, sx):
        x = args[0]
        res = []
        for o in outs:
            if tuple(o.shape) == tuple(x.shape) and name not in (
                    "permute", "transpose", "t", "expand", "unbind",
                    "split", "split_with_sizes", "chunk"):
                res.append(sx)
                continue
            if name == "permute":
                res.append(tuple(sx[d % x.dim()] for d in args[1]))
            elif name in ("transpose", "t"):
                d0, d1 = (0, 1) if name == "t" or x.dim() < 2 \
                    else (args[1] % x.dim(), args[2] % x.dim())
                s = list(sx)
                if x.dim() >= 2:
                    s[d0], s[d1] = s[d1], s[d0]
                res.append(tuple(s))
            elif name == "expand":
                nd = o.dim()
                s = []
                for j, n in enumerate(o.shape):
                    k = j - (nd - x.dim())
                    s.append(sx[k] if k >= 0 and x.shape[k] == n
                             else ((int(n), ()),))
                res.append(tuple(s))
            elif name in ("slice", "narrow", "split", "split_with_sizes",
                          "chunk") and o.dim() == x.dim():
                res.append(tuple(
                    sx[j] if o.shape[j] == x.shape[j] else
                    _cut(sx[j], o.shape[j], self.factor)
                    for j in range(x.dim())))
            elif name in ("select", "unbind") and o.dim() == x.dim() - 1:
                d = kwargs.get("dim", args[1] if len(args) > 1 else 0) \
                    % x.dim()
                res.append(sx[:d] + sx[d + 1:])
            elif o.numel() == x.numel():
                try:
                    res.append(_reshape(sx, o.shape, self.factor))
                except _Unresolved:
                    res.append(_replicated(o.shape))
            else:
                res.append(_replicated(o.shape))
        return res

    def _index(self, args, out, sx):
        """``x[..., idx, ...]`` with one index tensor (an embedding
        lookup): the result's dims are the index's, then ``x``'s after
        it; a split indexed dim is a masked gather and an all-reduce."""
        x, idx = args[0], args[1]
        tensors = [(k, t) for k, t in enumerate(idx) if t is not None]
        if len(tensors) != 1 or tensors[0][1].dtype == torch.bool:
            return None
        k, t = tensors[0]
        spec = sx[:k] + self.spec(t) + sx[k + 1:]
        if len(spec) != out.dim():
            return None
        spec = _dedupe(spec)
        red = self.reduce_axes(_dim_axes(sx[k]))
        if red:
            self.collective("all-reduce", self.local_bytes(out, spec), red)
        return spec

    def _effects(self, func, name, args, kwargs, flat_in, outs, out):
        """What one op does to the count: its outputs' placements, FLOPs,
        bytes, collectives, and the bytes of each output it allocates."""
        ins_specs = [self.spec(t) for t in flat_in]
        targs = [a for a in args if isinstance(a, torch.Tensor)]
        is_view = func.is_view or name in _VIEWLIKE
        flops = None
        if func in _PRODUCTS:
            out_specs, flops = self._product(func, args, out)
        elif is_view and flat_in:
            out_specs = self._view(name, args, kwargs, outs,
                                   self.spec(args[0]))
        elif name in _REDUCTIONS and targs and \
                not (name in ("max", "min") and len(targs) > 1):
            out_specs, flops = self._reduction(name, args, kwargs, outs,
                                               [self.spec(args[0])])
        elif name in _ALONG:
            out_specs, flops = self._along(name, args, outs,
                                           [self.spec(a) if isinstance(
                                               a, torch.Tensor) else None
                                            for a in args])
        else:
            spec = None
            if name in ("index", "_unsafe_index") and len(outs) == 1:
                spec = self._index(args, outs[0], self.spec(args[0]))
            elif name == "embedding" and len(outs) == 1:
                spec = self._index((args[0], [args[1]]), outs[0],
                                   self.spec(args[0]))
            elif name in ("cat", "stack") and args[0]:
                parts = [(self.spec(t), t.shape) for t in args[0]]
                d = kwargs.get("dim", args[1] if len(args) > 1 else 0)
                d = d % outs[0].dim()
                if name == "stack":
                    spec = _broadcast(outs[0].shape[:d] +
                                      outs[0].shape[d + 1:], parts)
                    spec = spec[:d] + (((int(outs[0].shape[d]), ()),),) \
                        + spec[d:]
                else:
                    spec = list(_broadcast(outs[0].shape, parts))
                    axes = {_dim_axes(s[d]) for s, _ in parts}
                    spec[d] = ((int(outs[0].shape[d]),
                                axes.pop() if len(axes) == 1 else ()),)
                    spec = _dedupe(spec)
            ins = [(s, t.shape) for s, t in zip(ins_specs, flat_in)]
            out_specs = [spec if spec is not None and i == 0 else
                         _broadcast(o.shape, ins) for i, o in enumerate(outs)]
            if name == "gather":
                # along a split dim: a masked gather, then an all-reduce
                d = args[1] % args[0].dim()
                red = self.reduce_axes(_dim_axes(ins_specs[0][d]))
                if red:
                    self.collective("all-reduce", self.local_bytes(
                        outs[0], out_specs[0]), red)
        if self.seq_shard is not None:
            b, s, d = self.seq_shard
            act = ((b, self.dp) if b % self.factor(self.dp) == 0
                   else (b, ()), (s, ("model",)), (d, ()))
            out_specs = [_dedupe(tuple((p,) for p in act))
                         if tuple(o.shape) == (b, s, d) else sp
                         for o, sp in zip(outs, out_specs)]
        if is_view:
            return _Effects(out_specs, 0, 0, [None] * len(outs), view=True)
        if flops is None:
            if name in _MOVES or name in _EMPTIES or (
                    name == "_to_copy" and outs and flat_in and
                    outs[0].dtype == flat_in[0].dtype):
                flops = 0
            else:
                flops = max([self.local_numel(sp) for sp in out_specs] +
                            [self.local_numel(sp) for sp in ins_specs]
                            or [0])
        nbytes = 0
        if name not in _EMPTIES:
            seen = set()
            for t, sp in zip(flat_in, ins_specs):
                if id(t) not in seen:
                    seen.add(id(t))
                    nbytes += self.local_numel(sp) * t.element_size()
            nbytes += sum(self.local_numel(sp) * o.element_size()
                          for o, sp in zip(outs, out_specs))
        fresh = [None if any(o is t for t in flat_in) else
                 self.local_numel(sp) * o.element_size()
                 for o, sp in zip(outs, out_specs)]
        return _Effects(out_specs, flops, nbytes, fresh)

    def _key(self, func, args, kwargs, flat_in):
        """What an op's effects depend on: the op, whether the backward
        pass runs it, its arguments (a tensor by shape, dtype and
        placement) and which of them are the same tensor; None where an
        argument cannot be hashed."""
        def arg(a):
            if isinstance(a, torch.Tensor):
                return (tuple(a.shape), a.dtype, self.spec(a))
            if isinstance(a, (list, tuple)):
                return tuple(arg(x) for x in a)
            hash(a)
            return a

        ids = [id(t) for t in flat_in]
        try:
            return (self._context, func,
                    torch._C._current_autograd_node() is not None,
                    arg(args), arg(tuple(sorted(kwargs.items()))),
                    tuple(ids.index(i) for i in ids))
        except TypeError:
            return None

    def _count(self, func, args, kwargs, out):
        name = func.overloadpacket.__name__
        flat_in = _tensors((args, tuple(kwargs.values())), [])
        outs = _tensors(out, [])
        if not any(o.device == self.device for o in outs + flat_in):
            return
        if name in _HOST_COPIES and flat_in:
            src = flat_in[-1 if name == "copy_" else 0]
            if src.device.type == "cpu" and src not in self.specs:
                return          # a constant from the host
        key = self._key(func, args, kwargs, flat_in)
        eff = _EFFECTS.get(key) if key is not None else None
        if eff is None:
            self._recording, self._product_flops = [], 0
            try:
                eff = self._effects(func, name, args, kwargs, flat_in,
                                    outs, out)
            finally:
                eff_colls, self._recording = self._recording, None
            eff.collectives = eff_colls
            eff.product_flops = self._product_flops
            if key is not None:
                if len(_EFFECTS) > _EFFECTS_MAX:
                    _EFFECTS.clear()
                _EFFECTS[key] = eff
        for o, sp in zip(outs, eff.out_specs):
            self.specs[o] = sp
        for c in eff.collectives:
            self.collective(*c)
        self.product_flops += eff.product_flops
        if eff.view:
            return
        self.flops += eff.flops
        self.bytes += eff.bytes
        entry = self.by_op.setdefault(name, [0, 0, 0])
        entry[0] += eff.flops
        entry[1] += eff.bytes
        entry[2] += 1
        # intermediates: every new tensor lives until its last reference
        for o, nb in zip(outs, eff.fresh):
            if nb is not None:
                self.live += nb
                self.peak = max(self.peak, self.live)
                weakref.finalize(o, self._free, nb)

    def _free(self, nb: int) -> None:
        self.live -= nb

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def result(self) -> dict:
        coll = dict(self.coll)
        coll["total"] = sum(self.coll.values())
        coll["traffic_total"] = sum(self.traffic.values())
        coll["traffic"] = dict(self.traffic)
        coll["counts"] = dict(self.counts)
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": coll["total"], "traffic": coll["traffic_total"],
                "coll_detail": coll,
                "product_flops": float(self.product_flops),
                "temp": self.peak,
                "by_op": {k: list(v) for k, v in self.by_op.items()}}


# --------------------------------------------------------------------- #
# Time loops counted once a chunk                                        #
# --------------------------------------------------------------------- #
class _Stretch(torch.autograd.Function):
    """One token's output ``[B, 1, ...]`` standing in for its chunk's
    ``[B, n, ...]``: the chunk's buffer is allocated (nothing written,
    nothing counted), and the backward pass takes the first token's
    gradient (a view).  The chunk's last state is an input too, so its
    gradient (a zero expanded to its shape) reaches the body's state
    update, as the later tokens' outputs would carry it."""

    @staticmethod
    def forward(ctx, y1, state, n):
        ctx.state = (tuple(state.shape), state.dtype)
        return y1.new_empty((y1.shape[0], n) + tuple(y1.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.state
        return g[:, :1], g.new_zeros((), dtype=dtype).expand(shape), None


def _stretch(y1: torch.Tensor, state: torch.Tensor, n: int) -> torch.Tensor:
    return y1 if n == 1 else _Stretch.apply(y1, state, n)


@contextmanager
def scans_counted_once():
    """While active, the Mamba and RWKV time loops run their body on one
    token a chunk (the port's own recurrence, ``_ssm_scan``,
    ``_wkv_chunk`` under the same checkpoint, ``rwkv_scan_plain``) and
    stand its output in for the chunk's: the recurrence is counted once a
    chunk, as XLA counts a ``while`` body once.  For counting only: the
    outputs past each chunk's first token are not computed."""
    from repro_torch.kernels.rwkv_scan import rwkv_scan_plain

    ssm_scan, wkv_chunk = mamba_mod._ssm_scan, rwkv_mod._wkv_chunk

    def ssm_once(h, delta, bu, cu, xu, a, chunk):
        s = delta.shape[1]
        ys = []
        for t0 in range(0, s, chunk):
            one = slice(t0, t0 + 1)
            h, y1 = ssm_scan(h, delta[:, one], bu[:, one], cu[:, one],
                             xu[:, one], a, 1)
            ys.append(_stretch(y1, h, min(chunk, s - t0)))
        return h, torch.cat(ys, dim=1)

    def wkv_once(s0, r, k, v, w, u, chunk):
        s = r.shape[1]
        n_chunks = -(-s // chunk)
        pad = n_chunks * chunk - s
        if pad:
            r, k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                       for t in (r, k, v))
            w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
        state, ys = s0, []
        for c in range(n_chunks):
            xs = [t[:, c * chunk:c * chunk + 1] for t in (r, k, v, w)]
            if torch.is_grad_enabled():
                state, y = torch.utils.checkpoint.checkpoint(
                    wkv_chunk, state, *xs, u, use_reentrant=False)
            else:
                state, y = wkv_chunk(state, *xs, u)
            ys.append(_stretch(y, state, chunk))
        return state, torch.cat(ys, dim=1)[:, :s]

    def scan_once(r, k, v, w, u, s0):
        y, s_n = rwkv_scan_plain(r[:, :1], k[:, :1], v[:, :1], w[:, :1],
                                 u, s0)
        return _stretch(y, s_n, r.shape[1]), s_n

    saved = (mamba_mod._ssm_scan, rwkv_mod._wkv_chunk_scan,
             rwkv_mod.rwkv_scan)
    mamba_mod._ssm_scan = ssm_once
    rwkv_mod._wkv_chunk_scan = wkv_once
    rwkv_mod.rwkv_scan = scan_once
    try:
        yield
    finally:
        (mamba_mod._ssm_scan, rwkv_mod._wkv_chunk_scan,
         rwkv_mod.rwkv_scan) = saved


# --------------------------------------------------------------------- #
# One step, counted                                                      #
# --------------------------------------------------------------------- #
def abstract_state(model, cfg, opt) -> TrainState:
    """The train state on ``meta``: params and AdamW moments, nothing
    allocated."""
    params = model.init(device="meta")
    return TrainState(params, opt.init(params), None)


def _batch_on(batch: dict, cfg, shape: ShapeSpec, device,
              generator) -> dict:
    """``input_specs``'s batch on a real ``device``: seeded token ids
    below ``cfg.vocab``, positions, frames, and ``cache_len`` the last
    slot of the cache."""
    out = {}
    for key, spec in batch.items():
        if key == "cache_len":
            out[key] = torch.tensor(shape.seq_len - 1, dtype=spec.dtype,
                                    device=device)
        elif key == "pos3d":
            pos = torch.arange(spec.shape[-1], dtype=spec.dtype,
                               device=device)
            out[key] = pos.expand(spec.shape).contiguous()
        elif spec.dtype.is_floating_point:
            out[key] = torch.randn(spec.shape, generator=generator,
                                   device=device).to(spec.dtype)
        else:
            out[key] = torch.randint(0, cfg.vocab, spec.shape,
                                     generator=generator, device=device,
                                     dtype=spec.dtype)
    return out


def _inputs(cfg, shape: ShapeSpec, mesh: GridMesh, device, generator):
    """The step of (cfg, shape) and its inputs on ``device``, with each
    input leaf's partition spec and each fixed output's (the new state's,
    the decode caches')."""
    model = build_model(cfg)
    batch = input_specs(cfg, shape)
    bspecs = sh.batch_specs(cfg, mesh, shape, batch)
    real = device.type != "meta"
    if real:
        batch = _batch_on(batch, cfg, shape, device, generator)
    placed = [(batch[k], bspecs[k]) for k in sorted(batch)]
    specs_of = lambda tree, plc: [
        (t, p.spec) for t, p in zip(tree_leaves(tree), tree_leaves(plc))]
    if shape.kind == "train":
        opt = AdamW(lr=3e-4)
        if real:
            params = model.init(generator=generator, device=device)
            state = TrainState(params, opt.init(params), None)
        else:
            state = abstract_state(model, cfg, opt)
        sspecs = specs_of(state, sh.param_shardings(cfg, mesh, state))
        step = make_train_step(model, cfg, opt)
        return (lambda: step(state, batch)), sspecs + placed, specs_of(
            state.params, sh.param_shardings(cfg, mesh, state.params))
    params = model.init(generator=generator, device=device)
    pspecs = specs_of(params, sh.param_shardings(cfg, mesh, params))
    if shape.kind == "prefill":
        return (lambda: model.prefill(params, batch)), pspecs + placed, None
    caches = model.init_caches(shape.global_batch, shape.seq_len,
                               device=device)
    cspecs = specs_of(caches, sh.cache_specs_tree(cfg, mesh, shape, caches))
    return (lambda: model.decode_step(params, batch, caches)), \
        pspecs + placed + cspecs, cspecs


def count_step(cfg, shape: ShapeSpec, mesh: GridMesh, *, device="meta",
               seq_shard: bool = False) -> dict:
    """Count the step of (cfg, shape) on ``mesh`` (module docstring):
    ``flops``, ``bytes``, ``coll`` and ``traffic`` per device, the
    collectives by kind (``coll_detail``), ``memory``, the global
    ``product_flops`` and the count ``by_op``.  ``device`` other than
    ``meta`` runs the real step there (seeded weights and batch) under
    the same counter: the count does not depend on the device."""
    device = torch.device(device)
    generator = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    step, inputs, fixed_out = _inputs(cfg, shape, mesh, device, generator)
    t_build = time.perf_counter() - t0
    act = (shape.global_batch, shape.seq_len, cfg.d_model) \
        if seq_shard and shape.kind != "decode" else None
    counter = StepCounter(mesh, device, seq_shard=act)
    argument = 0
    for t, spec in inputs:
        counter.place(t, spec)
        argument += math.prod(shard_shape(spec, mesh, t.shape)) \
            * t.element_size()
    with torch.no_grad() if shape.kind != "train" else nullcontext(), \
            scans_counted_once(), counter:
        out = step()
    if shape.kind == "train":
        for leaf, spec in fixed_out:
            counter.gradient_reduction(leaf, spec)
    t_count = time.perf_counter() - t0 - t_build
    res = counter.result()
    if shape.kind == "train":
        new_state, metrics = out
        output = sum(math.prod(shard_shape(p.spec, mesh, t.shape))
                     * t.element_size() for t, p in zip(
                         tree_leaves(new_state), tree_leaves(
                             sh.param_shardings(cfg, mesh, new_state))))
        output += sum(counter.local_bytes(t) for t in tree_leaves(metrics))
    else:
        logits, caches = out
        output = counter.local_bytes(logits)
        if fixed_out is not None:
            output += sum(math.prod(shard_shape(spec, mesh, t.shape))
                          * t.element_size() for t, spec in zip(
                              tree_leaves(caches), (s for _, s in fixed_out)))
        else:
            output += sum(counter.local_bytes(t) for t in tree_leaves(caches))
    res["memory"] = {"argument_size": float(argument),
                     "output_size": float(output),
                     "temp_size": float(res.pop("temp"))}
    res["lower_s"], res["compile_s"] = t_build, t_count
    return res


def _recurrence_flops(cfg, shape) -> float:
    """Analytic per-device FLOPs of sequential recurrences (mamba/rwkv)
    that hide inside time-dim scans (XLA counts the body once).  Small vs
    matmuls, but added for honesty.  Train counts fwd+bwd(+remat) ~4x."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 4.0 if shape.kind == "train" else 1.0
    per_tok = 0.0
    for mixer, _ in cfg.layer_plan():
        if mixer == "mamba":
            per_tok += 10.0 * cfg.mamba_d_inner * cfg.mamba_d_state
        elif mixer == "rwkv":
            per_tok += 8.0 * cfg.d_model * cfg.rwkv_head_dim
    return mult * per_tok * tokens / 256.0  # per device (single pod)


def _depth(cfg, periods: int):
    """``cfg`` cut to ``periods`` periods of its layer plan (an
    encoder-decoder: ``periods`` encoder and decoder layers)."""
    if cfg.encoder_layers:
        return cfg.replace(n_layers=periods, encoder_layers=periods)
    return cfg.replace(n_layers=periods * cfg.layer_period())


def _periods(cfg) -> float:
    return cfg.n_layers if cfg.encoder_layers \
        else cfg.n_layers / cfg.layer_period()


def _numbers(fn, *xs):
    """``fn`` over the numbers of equally nested dicts of numbers."""
    if isinstance(xs[0], dict):
        return {k: _numbers(fn, *(x[k] for x in xs)) for k in xs[0]}
    return fn(*xs)


_COMPOSED = ("flops", "bytes", "coll", "traffic", "coll_detail",
             "product_flops", "memory")


def _composed(counts: dict, periods: float, chunks: int = 1) -> dict:
    """A count of the whole from ``counts[(p, c)]``, the counts at ``p``
    periods and ``c`` chunks of each time loop: affine in the periods
    (from ``p`` = 1 and 2); past one chunk, every time loop lies inside a
    layer, and each chunk after the first two adds the same (the first
    chunk's input state needs no gradient, the later ones' do), so a
    period of ``n`` chunks adds ``X(1, 2) - X(1, 1)`` and ``(n - 2) / 2``
    times ``X(1, 4) - X(1, 2)``."""
    def whole(x1, x2):
        return x1 + (x2 - x1) * (periods - 1)

    def loops(x, x11, x12, x14):
        return x + ((x12 - x11) + (x14 - x12) * (chunks - 2) / 2) * periods

    out = {}
    for key in _COMPOSED:
        out[key] = _numbers(whole, counts[1, 1][key], counts[2, 1][key])
        if chunks != 1:
            out[key] = _numbers(loops, out[key], *(
                counts[1, c][key] for c in (1, 2, 4)))
    return out


def _time_chunks(cfg, shape) -> int:
    """Chunks each time loop of the step runs (1 without a recurrence,
    and in a decode step, one token)."""
    plan = {m for m, _ in cfg.layer_plan()}
    if shape.kind == "decode" or not plan & {"mamba", "rwkv"}:
        return 1
    if "rwkv" in plan:
        # a prefill runs rwkv_scan over the whole sequence at once
        return 1 if shape.kind == "prefill" else \
            -(-shape.seq_len // cfg.rwkv_chunk)
    return -(-shape.seq_len // cfg.mamba_chunk)


def count_cell(cfg, shape, mesh, seq_shard: bool = False,
               cache: dict | None = None) -> dict:
    """The count of the step at ``cfg``'s whole depth, composed from
    counts at one and two periods of its layers (the port's forward loops
    over layers in Python, so every layer of a period position counts
    alike): FLOPs, bytes, collectives and the argument and output bytes
    are affine in the depth, so the composition is exact at a whole
    number of periods; ``temp_size``, a peak, is composed the same way
    (each period adding its saved inputs or caches).  A time loop of
    ``n`` chunks is composed from one-period counts at one, two and four
    chunks (each chunk counts its body once; :func:`_composed`).
    ``cache`` maps configs to counts already made."""
    cache = {} if cache is None else cache
    n = _time_chunks(cfg, shape)
    seq = max(shape.seq_len, 1)
    counts = {}
    for k, c in ((1, 1), (2, 1)) + (((1, 2), (1, 4)) if n != 1 else ()):
        chunked = cfg.replace(mamba_chunk=-(-seq // c),
                              rwkv_chunk=-(-seq // c)) if n != 1 else cfg
        key = (_depth(chunked, k), shape, seq_shard)
        if key not in cache:
            cache[key] = count_step(key[0], shape, mesh, seq_shard=seq_shard)
        counts[k, c] = cache[key]
    out = _composed(counts, _periods(cfg), n)
    out["lower_s"] = sum(c["lower_s"] for c in counts.values())
    out["compile_s"] = sum(c["compile_s"] for c in counts.values())
    out["counts"] = counts
    return out


def calibrate(cfg, shape, mesh, seq_shard: bool = False,
              cache: dict | None = None) -> dict:
    """FLOPs/bytes/collectives of the whole depth from the 1-period and
    2-period counts:

        per_period = X(2p) - X(p);  total = X(p) - per_period
                                            + per_period * (L / p)

    each count with ``mamba_chunk = rwkv_chunk = seq`` (one chunk: the
    recurrence body counted once, as XLA counts it), plus
    :func:`_recurrence_flops`, as the reference calibrates.  An
    encoder-decoder's encoder and decoder scale together."""
    seq = shape.seq_len
    one_chunk = cfg.replace(mamba_chunk=max(seq, 1), rwkv_chunk=max(seq, 1))
    got = count_cell(one_chunk, shape, mesh, seq_shard, cache)
    a, b = got["counts"][1, 1], got["counts"][2, 1]
    out = {key: got[key] for key in ("flops", "bytes", "coll", "traffic")}
    out["flops"] += _recurrence_flops(cfg, shape)
    out["one_period"] = a
    out["two_period"] = b
    return out


VARIANTS = {
    # hillclimb levers (EXPERIMENTS.md §Perf)
    "baseline": {},
    "opt_banded": {"window_banded": True},
    "opt_lastlogits": {"prefill_last_only": True},
    "opt_savedots": {"remat_policy": "save_dots"},
    "opt_losschunk": {"loss_chunk": 512},
    "opt_all": {"window_banded": True, "prefill_last_only": True,
                "remat_policy": "save_dots"},
    "opt_sp": {"prefill_last_only": True, "_seq_shard": True},
    "opt_banded_losschunk": {"window_banded": True, "loss_chunk": 1024},
    "opt_moe_gather": {"moe_dispatch": "gather"},
    # the paper's technique at production scale: width-nested variant;
    # 'masked' is the paper-faithful dense-masked infrastructure burden,
    # 'blocks' the triangular execution of the live blocks.
    "anytime_masked": {"nest_levels": 4, "nest_backend": "masked"},
    "anytime_blocks": {"nest_levels": 4, "nest_backend": "blocks"},
}


def run_cell(arch: str, shape: ShapeSpec, multi_pod: bool,
             variant: str = "baseline",
             calibrate_flops: bool = True) -> dict:
    """The record of one cell (module docstring).  ``skip`` carries
    ``cell_supported``'s reason, or, for a variant the port's config
    refuses (width nesting on a MoE, hybrid or RWKV arch), that
    refusal."""
    cfg = configs.get_config(arch)
    if variant not in VARIANTS:
        raise KeyError(f"unknown variant {variant!r}")
    overrides = dict(VARIANTS[variant])
    seq_shard = overrides.pop("_seq_shard", False)
    rec = {"arch": arch, "shape": shape.name, "kind": shape.kind,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "variant": variant, "status": "skip"}
    try:
        cfg = cfg.replace(**overrides)
    except ValueError as e:
        rec["reason"] = f"variant {variant!r}: {e}"
        return rec
    ok, reason = cell_supported(cfg, shape)
    rec["reason"] = reason
    if not ok:
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    cache = {}
    raw = count_cell(cfg, shape, mesh, seq_shard, cache)
    rec.update({
        "status": "ok",
        "lower_s": round(raw["lower_s"], 1),
        "compile_s": round(raw["compile_s"], 1),
        "n_devices": mesh.size,
        "flops_per_device": raw["flops"],
        "bytes_per_device": raw["bytes"],
        "collective_bytes_per_device": raw["coll_detail"],
        "memory": dict(raw["memory"], generated_code_size=None),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "hlo_bytes": None,
    })
    if calibrate_flops and not multi_pod:
        cal = calibrate(cfg, shape, mesh, seq_shard, cache)
        rec["calibrated"] = {
            "flops_per_device": cal["flops"],
            "bytes_per_device": cal["bytes"],
            "collective_bytes_per_device": cal["coll"],
            "collective_traffic_per_device": cal["traffic"],
            "one_period": {k: cal["one_period"][k]
                           for k in ("flops", "bytes", "coll")},
            "two_period": {k: cal["two_period"][k]
                           for k in ("flops", "bytes", "coll")},
        }
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    archs = configs.ARCH_IDS if (args.all or not args.arch) \
        else [args.arch]
    shapes = list(SHAPES.values()) if (args.all or not args.shape) \
        else [SHAPES[args.shape]]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                tag = f"{arch}__{shape.name}__" \
                      f"{'multi' if multi else 'single'}__{args.variant}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        old = json.load(f)
                    done = old.get("status") == "skip" or (
                        old.get("status") == "ok" and
                        (multi or "calibrated" in old))
                    if done:
                        print(f"[cached] {tag}")
                        continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi, args.variant)
                except Exception as e:
                    rec = {"arch": arch, "shape": shape.name,
                           "mesh": "2x16x16" if multi else "16x16",
                           "variant": args.variant,
                           "status": "fail", "error": str(e)[-2000:],
                           "traceback": traceback.format_exc()[-4000:]}
                    n_fail += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"  -> {rec['status']} "
                      f"(count {rec.get('compile_s', '-')}s, "
                      f"flops {rec.get('flops_per_device', '-')})",
                      flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
