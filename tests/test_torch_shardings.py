"""The data plane's rules and shapes (``repro_torch.launch.shardings``,
``repro_torch.configs.shapes``) against the reference's, for every arch at
its full config, nothing allocated: the reference's state through
``jax.eval_shape`` on ``AbstractMesh``es of 16x16 and 2x16x16, the port's
on the ``meta`` device over ``make_production_mesh(device="meta")``.

The reference scans its layers, so its layer leaves carry a leading
repeat axis (``group/pos<p>``; a whisper stack, its layer axis); the
port's layers are a list.  The leaves are paired through the layout
``repro_torch.convert`` carries weights by, and a stacked leaf's shape and
spec are compared with their leading entry dropped (which must be
``None``).  Tolerance: ``==`` throughout.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jc
from repro.configs import shapes as jshapes
from repro.launch import shardings as jsh
from repro.models.registry import build_model as j_build
from repro.optim.adamw import AdamW as JAdamW
from repro_torch import configs as tc
from repro_torch.configs import shapes as tshapes
from repro_torch.launch import mesh as tm
from repro_torch.launch import shardings as tsh
from repro_torch.models.attention import KVCache
from repro_torch.models.registry import build_model as t_build
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.tree import children, tree_leaves, tree_map_with_path

MESHES = {
    "16x16": (lambda: AbstractMesh((16, 16), ("data", "model")),
              lambda: tm.make_production_mesh(device="meta")),
    "2x16x16": (lambda: AbstractMesh((2, 16, 16), ("pod", "data", "model")),
                lambda: tm.make_production_mesh(multi_pod=True,
                                                device="meta")),
}


class R:
    """A reference leaf's shape, dtype and spec (a class, so no tree walk
    descends into it)."""

    def __init__(self, shape, dtype=None, spec=None):
        self.shape, self.dtype = tuple(shape), dtype
        self.spec = None if spec is None else tuple(spec)

    def unstacked(self):
        if self.spec is not None and len(self.spec) == len(self.shape):
            assert self.spec[0] is None, self.spec
            spec = self.spec[1:]
        else:
            spec = self.spec
        return R(self.shape[1:], self.dtype, spec)


def _walk(tree, fn):
    """``fn`` over the leaves of a nested dict / namedtuple / tuple."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, fn) for v in tree)
    return fn(tree)


def _index(tree, i):
    """Entry ``i`` of every stacked leaf of ``tree`` (all entries share a
    shape and spec)."""
    return _walk(tree, lambda r: r.unstacked())


def lm_layout(tree, cfg):
    """A reference LM tree (params, a moment, or caches) of ``R`` leaves in
    the port's layout: ``group/pos<p>`` entry ``rep`` is layer ``rep *
    period + p``, then ``rem<i>``."""
    layers = []
    group = tree.get("group", {})
    if group:
        first = tree_leaves_r(group["pos0"])[0]
        for rep in range(first.shape[0]):
            for pos in range(len(group)):
                layers.append(_index(group[f"pos{pos}"], rep))
    i = 0
    while f"rem{i}" in tree:
        layers.append(tree[f"rem{i}"])
        i += 1
    assert len(layers) == cfg.n_layers
    return layers


def tree_leaves_r(tree):
    out = []
    _walk(tree, out.append)
    return out


def params_layout(tree, cfg):
    if cfg.encoder_layers:
        out = {k: v for k, v in tree.items()
               if k not in ("encoder", "decoder")}
        for name, n in (("encoder", cfg.encoder_layers),
                        ("decoder", cfg.n_layers)):
            out[name] = [_index(tree[name], i) for i in range(n)]
        return out
    out = {k: v for k, v in tree.items()
           if k != "group" and not k.startswith("rem")}
    out["layers"] = lm_layout(tree, cfg)
    return out


def caches_layout(tree, cfg):
    if cfg.encoder_layers:
        k, v = tree["cross"]
        return {"self": [_index(tree["self"], i) for i in range(cfg.n_layers)],
                "cross": [KVCache(k.unstacked(), v.unstacked())
                          for _ in range(cfg.n_layers)]}
    return lm_layout(tree, cfg)


def port_leaves(tree):
    """``(path, leaf)`` pairs of a port-layout tree in the port's order
    (placements and ``R`` are leaves)."""
    if isinstance(tree, (dict, list, tuple)):
        return [(f"{n}/{p}" if p else n, leaf)
                for n, child in children(tree)
                for p, leaf in port_leaves(child)]
    return [("", tree)]


def with_specs(abstract, shardings):
    return jax.tree.map(lambda leaf, s: R(leaf.shape, leaf.dtype, s.spec),
                        abstract, shardings)


@functools.lru_cache(maxsize=None)
def ref_state(arch):
    cfg = jc.get_config(arch)
    model = j_build(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    return cfg, model, params, jax.eval_shape(JAdamW().init, params)


@functools.lru_cache(maxsize=None)
def port_state(arch):
    cfg = tc.get_config(arch)
    model = t_build(cfg)
    params = model.init(device="meta")
    return cfg, model, params, TAdamW().init(params)


def assert_same(ref, got, what):
    """``ref`` (port-layout tree of ``R``) against ``got`` (port-layout
    tree of placements or ``meta`` tensors), leaf by leaf."""
    want, have = port_leaves(ref), port_leaves(got)
    assert [p for p, _ in want] == [p for p, _ in have], what
    for (path, r), (_, leaf) in zip(want, have):
        if hasattr(leaf, "spec"):
            assert tuple(leaf.spec) == r.spec, (what, path, r.spec,
                                                leaf.spec)
        else:
            assert tuple(leaf.shape) == r.shape, (what, path)


# --------------------------------------------------------------------- #
# configs/shapes.py                                                      #
# --------------------------------------------------------------------- #
def test_arch_ids_are_the_references():
    assert tc.ARCH_IDS == jc.ARCH_IDS
    assert sorted(tc.ALL_IDS) == sorted(jc.ALL_IDS)


@pytest.mark.parametrize("arch", jc.ALL_IDS)
def test_shapes_match_the_reference(arch):
    """``cell_supported``, ``input_specs`` (keys, shapes, dtypes; tokens and
    labels int64 where the reference's are int32) and ``cache_specs``'s
    leaf shapes, for every shape."""
    j_cfg, j_model, _, _ = ref_state(arch)
    t_cfg, t_model, _, _ = port_state(arch)
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, j_shape in jshapes.SHAPES.items():
        t_shape = tshapes.SHAPES[name]
        assert dataclass_tuple(t_shape) == dataclass_tuple(j_shape)
        assert tshapes.cell_supported(t_cfg, t_shape) == \
            jshapes.cell_supported(j_cfg, j_shape)
        want = jshapes.input_specs(j_cfg, j_shape)
        got = tshapes.input_specs(t_cfg, t_shape)
        assert list(got) == list(want)
        for k, leaf in got.items():
            assert leaf.device.type == "meta"
            assert tuple(leaf.shape) == tuple(want[k].shape), k
            ref_dtype = str(want[k].dtype)
            if k in ("tokens", "labels"):
                assert ref_dtype == "int32" and leaf.dtype == torch.int64
            else:
                assert str(leaf.dtype).removeprefix("torch.") == ref_dtype
        if not tshapes.cell_supported(t_cfg, t_shape)[0]:
            continue
        j_caches = jshapes.cache_specs(j_cfg, j_shape, j_model)
        t_caches = tshapes.cache_specs(t_cfg, t_shape, t_model)
        ref = caches_layout(jax.tree.map(lambda x: R(x.shape, x.dtype),
                                         j_caches), j_cfg)
        assert all(x.device.type == "meta" for x in tree_leaves(t_caches))
        assert_same(ref, t_caches, f"{arch} {name} caches")


def dataclass_tuple(s):
    return (s.name, s.seq_len, s.global_batch, s.kind)


def test_model_init_on_meta_allocates_nothing():
    """Every leaf of the full ``qwen2.5-32b`` and its AdamW state lies on
    ``meta`` with the reference's shape and dtype."""
    cfg, _, params, opt_state = port_state("qwen2.5-32b")
    _, _, j_params, _ = ref_state("qwen2.5-32b")
    ref = params_layout(jax.tree.map(lambda x: R(x.shape, x.dtype),
                                     j_params), cfg)
    for (path, r), (_, leaf) in zip(port_leaves(ref), port_leaves(params)):
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == r.shape, path
        assert str(leaf.dtype).removeprefix("torch.") == str(r.dtype), path
    assert all(x.device.type == "meta" and x.dtype == torch.float32
               for x in tree_leaves(opt_state.m))


# --------------------------------------------------------------------- #
# launch/shardings.py                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jc.ALL_IDS)
def test_param_and_moment_specs_match(arch, mesh_name):
    """``param_shardings`` over params, AdamW's moments and ``step``: every
    leaf's spec the reference's with the stacking ``None`` dropped (so
    the MoE rule's ``shape[-3] == n_experts`` picks the same leaves in
    the unstacked tree)."""
    j_mesh, t_mesh = (f() for f in MESHES[mesh_name])
    j_cfg, _, j_params, j_opt = ref_state(arch)
    t_cfg, _, t_params, t_opt = port_state(arch)
    j_state = (j_params, j_opt)
    ref = jax.tree.map(lambda leaf, s: R(leaf.shape, leaf.dtype, s.spec),
                       j_state, jsh.param_shardings(j_cfg, j_mesh, j_state))
    got = tsh.param_shardings(t_cfg, t_mesh, (t_params, t_opt))
    assert tuple(got[1].step.spec) == tuple(ref[1].step.spec) == ()
    for k in (0, 1, 2):
        j_tree = ref[0] if k == 0 else (ref[1].m, ref[1].v)[k - 1]
        t_tree = got[0] if k == 0 else (got[1].m, got[1].v)[k - 1]
        assert_same(params_layout(j_tree, j_cfg), t_tree,
                    f"{arch} {mesh_name} tree {k}")
    assert all(p.mesh is t_mesh for p in tree_leaves(got))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", jc.ALL_IDS)
def test_batch_and_cache_specs_match(arch, mesh_name):
    """``batch_specs`` for every shape and ``cache_specs_tree`` for every
    supported shape, entry for entry."""
    j_mesh, t_mesh = (f() for f in MESHES[mesh_name])
    j_cfg, j_model, _, _ = ref_state(arch)
    t_cfg, t_model, _, _ = port_state(arch)
    for name, j_shape in jshapes.SHAPES.items():
        t_shape = tshapes.SHAPES[name]
        want = jsh.batch_specs(j_cfg, j_mesh, j_shape,
                               jshapes.input_specs(j_cfg, j_shape))
        got = tsh.batch_specs(t_cfg, t_mesh, t_shape,
                              tshapes.input_specs(t_cfg, t_shape))
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, name
        assert all(isinstance(v, tsh.PartitionSpec) for v in got.values())
        if not jshapes.cell_supported(j_cfg, j_shape)[0]:
            continue
        j_caches = jshapes.cache_specs(j_cfg, j_shape, j_model)
        ref = caches_layout(with_specs(j_caches, jsh.cache_specs_tree(
            j_cfg, j_mesh, j_shape, j_caches)), j_cfg)
        got = tsh.cache_specs_tree(t_cfg, t_mesh, t_shape,
                                   tshapes.cache_specs(t_cfg, t_shape,
                                                       t_model))
        assert_same(ref, got, f"{arch} {mesh_name} {name} caches")


def test_partition_spec_entries_are_jaxs():
    from jax.sharding import PartitionSpec as JP
    for entries in [(), (None,), ("data", None), (("data",), None),
                    (("pod", "data"), "model"), (None, ("data", "model"))]:
        assert tuple(tsh.P(*entries)) == tuple(JP(*entries))
    mesh = MESHES["16x16"][1]()
    placements = tsh.named(mesh, {"a": tsh.P("data", None), "b": [tsh.P()]})
    assert tuple(placements["a"].spec) == ("data", None)
    assert tuple(placements["b"][0].spec) == ()


# The reference's TestShardingRules (tests/test_distributed.py), ported.
@pytest.mark.parametrize("arch", tc.ALL_IDS)
def test_param_specs_cover_every_leaf(arch):
    cfg = tc.get_reduced(arch)
    params = t_build(cfg).init(device="meta")

    def check(path, leaf):
        spec = tsh.spec_for(cfg, path, leaf)
        assert len(spec) <= len(leaf.shape), f"{arch}: {path}"

    tree_map_with_path(check, params)


def test_moe_expert_dim_sharded():
    cfg = tc.get_config("qwen3-moe-30b-a3b")
    params = t_build(cfg.replace(n_layers=1)).init(device="meta")
    found = []

    def check(path, leaf):
        if path[-1] == "w_gate" and cfg.n_experts in leaf.shape:
            assert "model" in tsh.spec_for(cfg, path, leaf)
            found.append(path)

    tree_map_with_path(check, params)
    assert found == [("layers", "0", "ffn", "w_gate")]


def test_attention_tp_pattern():
    cfg = tc.get_config("qwen2.5-32b")
    wq = torch.empty((cfg.d_model, 5120), dtype=torch.bfloat16,
                     device="meta")
    assert tsh.spec_for(cfg, ("wq",), wq) == tsh.P(None, "model")
    assert tsh.spec_for(cfg, ("wo",), wq) == tsh.P("model", None)


def test_production_mesh_and_batch_axes():
    for name, (jf, tf) in MESHES.items():
        j_mesh, t_mesh = jf(), tf()
        assert t_mesh.shape == tuple(j_mesh.shape.values())
        assert t_mesh.axis_names == j_mesh.axis_names
        assert t_mesh.size == int(np.prod(t_mesh.shape))
        assert all(d.type == "meta" for d in t_mesh.devices.flat)
        from repro.launch.mesh import batch_axes as j_batch_axes
        assert tm.batch_axes(t_mesh) == j_batch_axes(j_mesh)
        assert t_mesh.axis_size("model") == 16
