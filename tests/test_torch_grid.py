"""The data plane's (data, model) grid on the CPU: ``GridMesh``,
``GridShards``, ``shard_shape``, ``remesh``, ``reshard_state``, grid
checkpoints, and the grid train step (``make_grid_train_step``) against
the port's unsharded step and the reference's one-device step.

Grids of several shards lie on the one CPU device
(``make_host_mesh(mp, devices=["cpu"] * n)``), the counterpart of the
reference's faked host devices.  Tolerance: ``==`` (bitwise) unless a
test states otherwise; against the reference, ``test_torch_train_step``'s
float32 bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.models.registry import build_model as j_build
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as j_cosine
from repro.runtime import elastic as je
from repro.train import step as js
from repro_torch import configs as tc
from repro_torch.checkpoint import io as tio
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.launch import mesh as tm
from repro_torch.launch import shardings as tsh
from repro_torch.models.registry import build_model as t_build
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import cosine_schedule as t_cosine
from repro_torch.runtime import elastic as te
from repro_torch.train import step as ts
from repro_torch.tree import tree_leaves, tree_map
from tests.test_torch_train_grads import pair
from tests.test_torch_train_step import LR, STEPS, check_params

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """These models' ops are small: one intra-op thread computes them as
    fast, where the default (a thread a core) spins beside the suite's
    other workers.  Restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def grid(mp, n):
    return tm.make_host_mesh(mp, devices=[CPU] * n)


def joined(tree):
    return tree_map(lambda x: x.full(CPU)
                    if isinstance(x, tm.GridShards) else x, tree)


def placed(cfg, mesh, state):
    return tree_map(lambda leaf, where: where.place(leaf), state,
                    tsh.param_shardings(cfg, mesh, state))


def assert_trees_equal(a, b):
    la, lb = tree_leaves(joined(a)), tree_leaves(joined(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --------------------------------------------------------------------- #
# Meshes and blocks                                                      #
# --------------------------------------------------------------------- #
def test_production_mesh_refuses_too_few_cards():
    """Without CUDA cards (here) ``make_production_mesh()`` refuses rather
    than fakes; ``device="meta"`` reckons over the grid instead."""
    with pytest.raises(RuntimeError, match="needs 256 CUDA devices"):
        tm.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 CUDA devices"):
        tm.make_production_mesh(multi_pod=True)
    assert tm.make_production_mesh(device="meta").shape == (16, 16)


@pytest.mark.parametrize("n,mp", [(256, 16), (224, 16), (100, 16),
                                  (8, 2), (4, 1)])
def test_remesh_matches_the_reference(monkeypatch, n, mp):
    """The reference's ``remesh`` over ``n`` stand-in devices (its ``Mesh``
    recorded, as jax needs real devices) against the port's over ``n``
    shards on the CPU: shape and axes equal."""
    monkeypatch.setattr(je, "Mesh", lambda arr, axes: (arr, axes))
    arr, axes = je.remesh(devices=list(range(n)), model_parallel=mp)
    mesh = te.remesh([CPU] * n, model_parallel=mp)
    assert isinstance(mesh, tm.GridMesh)
    assert mesh.shape == arr.shape and mesh.axis_names == axes
    assert mesh.size == arr.size and all(d == CPU for d in mesh.devices.flat)


SHAPES = [(64, 32), (33, 5), (7,), (256, 16, 8), (1, 3), ()]
SPECS = [(), ("data",), ("data", "model"), (None, "model"), ("model",),
         (("data", "model"),), (None, ("pod", "data")), ("pod", None, "model")]


@pytest.mark.parametrize("axes,shape", [(("data", "model"), (4, 2)),
                                        (("data", "model"), (16, 16)),
                                        (("pod", "data", "model"),
                                         (2, 16, 16))])
def test_shard_shape_matches_jax(axes, shape):
    """``shard_shape`` equals ``NamedSharding.shard_shape`` wherever jax
    takes the shape, and is the ceiling where jax refuses an uneven
    split."""
    j_mesh = AbstractMesh(shape, axes)
    t_mesh = tm.GridMesh(np.array([torch.device("meta")] * int(np.prod(
        shape)), dtype=object).reshape(shape), axes)
    checked = uneven = 0
    for spec in SPECS:
        if any(a not in axes for e in spec for a in
               ((e,) if isinstance(e, str) else (e or ()))):
            continue
        for leaf in SHAPES:
            if len(spec) > len(leaf):
                continue
            got = tm.shard_shape(spec, t_mesh, leaf)
            try:
                want = NamedSharding(j_mesh, JP(*spec)).shard_shape(leaf)
            except ValueError:
                splits = [int(np.prod([t_mesh.axis_size(a) for a in
                                       ((e,) if isinstance(e, str)
                                        else (e or ()))]))
                          for e in spec + (None,) * (len(leaf) - len(spec))]
                assert got == tuple(-(-n // a) for n, a in zip(leaf, splits))
                uneven += 1
                continue
            assert got == tuple(want), (spec, leaf)
            checked += 1
    assert checked and uneven


def test_grid_blocks_follow_jax_layout():
    """An uneven split: shard k of a split a ways holds ``[k * ceil(n/a),
    min((k+1) * ceil(n/a), n))``, trailing blocks short or empty; an
    unnamed axis holds copies; ``full`` joins them."""
    mesh = grid(2, 8)                       # (4, 2)
    x = torch.arange(7 * 5, dtype=torch.float32).reshape(7, 5)
    g = tm.GridPlacement(mesh, tsh.P(("data", "model"))).place(x)
    rows = [g.parts[idx].shape[0] for idx in np.ndindex(mesh.shape)]
    assert rows == [1] * 7 + [0]
    g = tm.GridPlacement(mesh, tsh.P("data", "model")).place(x)
    assert [tuple(g.parts[i, j].shape) for i in range(4) for j in range(2)] \
        == [(2, 3), (2, 2)] * 3 + [(1, 3), (1, 2)]
    assert torch.equal(g.full(), x) and g.dtype == x.dtype
    r = tm.GridPlacement(mesh, tsh.P(None, "model")).place(x)
    assert all(torch.equal(r.parts[i, 1], r.parts[0, 1]) for i in range(4))
    assert all(p.device == CPU for p in r.parts.flat)
    with pytest.raises(ValueError, match="twice"):
        tm.GridPlacement(mesh, ("data", "data")).place(x)
    with pytest.raises(ValueError, match="not one of"):
        tm.GridPlacement(mesh, ("pod",)).place(x)
    with pytest.raises(ValueError, match="more entries"):
        tm.GridPlacement(mesh, (None, None, None)).place(x)


@pytest.mark.parametrize("mp,n", [(2, 8), (2, 4), (1, 1)])
def test_reshard_state_joins_back_bitwise(mp, n):
    """A reduced MoE model's train state placed by ``param_shardings``
    through ``reshard_state`` onto (4, 2), (2, 2) and (1, 1) grids: every
    block the slice of its leaf on its device, every leaf joined back
    bitwise."""
    cfg = tc.get_reduced("olmoe-1b-7b").replace(dtype="float32")
    model, opt = t_build(cfg), TAdamW()
    state = ts.init_train_state(model, cfg, opt,
                                torch.Generator().manual_seed(0), device=CPU)
    mesh = grid(mp, n)
    out = te.reshard_state(state, mesh,
                           lambda path, leaf: tsh.spec_for(cfg, path, leaf))
    assert_trees_equal(out, state)
    for leaf in tree_leaves(out):
        assert isinstance(leaf, tm.GridShards) and leaf.mesh == mesh
        want = tm.shard_shape(leaf.spec, mesh, leaf.shape)
        full = leaf.full()
        for idx in np.ndindex(mesh.shape):
            assert torch.equal(leaf.parts[idx], full[leaf.slices(idx)])
            assert all(a <= b for a, b in zip(leaf.parts[idx].shape, want))


# --------------------------------------------------------------------- #
# Checkpoints                                                            #
# --------------------------------------------------------------------- #
def test_checkpoint_reshard_roundtrip(tmp_path):
    """The reference's ``test_checkpoint_reshard_roundtrip``: ``arange(64)
    .reshape(8, 8)`` saved from a (4, 2) grid under ``P("data",
    "model")`` restores onto (2, 2), equal, at step 5; a bf16 leaf by its
    bits, and onto a ``meta`` like tree (abstract state)."""
    mesh8 = grid(2, 8)
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    b = torch.randn(8, 3, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    tree = {"w": tm.GridPlacement(mesh8, tsh.P("data", "model")).place(w),
            "b": tm.GridPlacement(mesh8, tsh.P("data")).place(b)}
    tio.save(str(tmp_path / "ck"), tree, step=5)
    mesh4 = te.remesh([CPU] * 4, model_parallel=2)
    assert mesh4.shape == (2, 2)
    shardings = tsh.named(mesh4, {"w": tsh.P("data", "model"),
                                  "b": tsh.P(None, "model")})
    restored, step = tio.restore(str(tmp_path / "ck"), tree,
                                 shardings=shardings)
    assert step == 5
    np.testing.assert_array_equal(restored["w"].full().numpy(), w)
    assert restored["w"].mesh == mesh4 and restored["b"].spec == \
        (None, "model")
    assert torch.equal(restored["b"].full(), b)
    like = {"w": torch.empty((8, 8), device="meta"),
            "b": torch.empty((8, 3), dtype=torch.bfloat16, device="meta")}
    again, _ = tio.restore(str(tmp_path / "ck"), like, shardings=shardings)
    assert torch.equal(again["b"].full(), b)
    same, _ = tio.restore(str(tmp_path / "ck"), tree)
    assert same["w"].mesh == mesh8 and torch.equal(same["b"].full(), b)


# --------------------------------------------------------------------- #
# The grid train step                                                    #
# --------------------------------------------------------------------- #
# The reduced archs of the reference's mini dry run
# (tests/test_distributed.py), float32, vocab 64, a batch of 8 (16
# tokens a row here; phase 38 (e) of chip_smoke.py runs its [8, 32]);
# and the anytime LM with its joint loss.  The last entry is the
# reference's microbatch count held against: one (its unsharded step)
# but for jamba.  A MoE layer routes each dispatch group of min(512,
# tokens) tokens under a capacity set by the group, and its aux loss is
# a product of means over the batch, so a data shard's 32 tokens route
# as their own group: the grid step (as ``microbatches=4``) is another
# function than the one over the whole 128-token batch (its loss and aux
# loss differ from the one-microbatch step's past rtol 1e-5), and is held
# to the reference's ``microbatches=4`` step, which computes it.
GRID_ARCHS = [("gemma3-1b", 64, 16, 1), ("jamba-v0.1-52b", 64, 16, 4),
              ("rwkv6-3b", 64, 16, 1), ("alert-anytime-120m", None, 16, 1)]


def losses_for(cfg, j_cfg, t_model, j_model):
    if cfg.nest_levels > 1:
        return (ts.make_anytime_loss_fn(t_model, cfg),
                js.make_anytime_loss_fn(j_model, j_cfg))
    return None, None


@pytest.mark.parametrize("arch,vocab,seq,j_micro", GRID_ARCHS)
def test_grid_step_equals_microbatches_and_follows_the_reference(
        arch, vocab, seq, j_micro):
    """Three steps on a (4, 2) grid from the reference's weights (carried
    by ``convert.py``): loss, metrics and every leaf bitwise the port's
    unsharded ``microbatches=4`` step after each step, and within
    ``test_torch_train_step``'s float32 bounds of the reference's
    one-device ``make_train_step(microbatches=j_micro)`` (metrics within
    rtol 1e-5)."""
    kw = {"vocab": vocab} if vocab else {}
    j_cfg, t_cfg, j_params, t_params = pair(arch, **kw)
    t_model, j_model = t_build(t_cfg), j_build(j_cfg)
    t_opt = TAdamW(lr=t_cosine(LR, 1, STEPS))
    j_opt = JAdamW(lr=j_cosine(LR, 1, STEPS))
    t_loss, j_loss = losses_for(t_cfg, j_cfg, t_model, j_model)
    mesh = grid(2, 8)
    state = ts.init_train_state(t_model, t_cfg, t_opt, params=t_params)
    g_state = placed(t_cfg, mesh, state)
    g_step = ts.make_grid_train_step(t_model, t_cfg, t_opt, mesh,
                                     loss_fn=t_loss)
    u_step = ts.make_train_step(t_model, t_cfg, t_opt, microbatches=4,
                                loss_fn=t_loss)
    j_step = jax.jit(js.make_train_step(j_model, j_cfg, j_opt,
                                        microbatches=j_micro,
                                        loss_fn=j_loss))
    j_state = js.TrainState(j_params, j_opt.init(j_params), None)
    data = SyntheticLM(vocab=t_cfg.vocab, seq_len=seq, global_batch=8)
    for i in range(STEPS):
        batch = data.batch_at(i)
        t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        g_state, g_met = g_step(g_state, t_batch)
        state, u_met = u_step(state, t_batch)
        j_state, j_met = j_step(j_state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        assert list(g_met) == list(u_met) and g_met.keys() == j_met.keys()
        for k in u_met:
            assert torch.equal(g_met[k], u_met[k]), k
            np.testing.assert_allclose(float(g_met[k]), float(j_met[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        assert_trees_equal(g_state, state)
    assert all(isinstance(x, tm.GridShards) for x in tree_leaves(g_state))
    check_params(t_cfg, j_state, joined(g_state))


@pytest.mark.parametrize("arch,moe", [("jamba-v0.1-52b", True),
                                      ("gemma3-1b", False)])
def test_a_moe_loss_is_the_microbatch_function(arch, moe):
    """Why jamba is held to the reference's ``microbatches=4`` step: its
    MoE routes each data shard's (each microbatch's) tokens as their own
    dispatch group, so the mean of four pieces' losses differs from the
    whole batch's past rtol 1e-5; a dense model's agrees within it."""
    cfg = tc.get_reduced(arch).replace(dtype="float32", vocab=64)
    model = t_build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    loss_fn = ts.make_loss_fn(model, cfg)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(vocab=64, seq_len=16, global_batch=8).batch_at(0)
             .items()}
    with torch.no_grad():
        whole = float(loss_fn(params, batch)[0])
        pieces = float(sum(loss_fn(params, {k: v[2 * i:2 * i + 2]
                                            for k, v in batch.items()})[0]
                           for i in range(4)) / 4)
    assert (abs(pieces - whole) > 1e-5 * abs(whole)) == moe, (whole, pieces)


def test_grid_step_with_microbatches_and_compression():
    """A (2, 2) grid with two microbatches a data shard and compression
    equals the unsharded ``microbatches=4`` step with compression,
    bitwise; the residuals stay grid-sharded."""
    _, cfg, _, params = pair("alert-anytime-120m")
    model, opt = t_build(cfg), TAdamW(lr=t_cosine(LR, 1, STEPS))
    loss = ts.make_anytime_loss_fn(model, cfg)
    state = ts.init_train_state(model, cfg, opt, params=params,
                                compress=True)
    mesh = grid(2, 4)
    g_state = placed(cfg, mesh, state)
    g_step = ts.make_grid_train_step(model, cfg, opt, mesh, microbatches=2,
                                     compress=True, loss_fn=loss)
    u_step = ts.make_train_step(model, cfg, opt, microbatches=4,
                                compress=True, loss_fn=loss)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=8, global_batch=8)
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
        g_state, g_met = g_step(g_state, batch)
        state, u_met = u_step(state, batch)
        assert all(torch.equal(g_met[k], u_met[k]) for k in u_met)
        assert_trees_equal(g_state, state)
    assert isinstance(tree_leaves(g_state.compress_state)[0], tm.GridShards)
    with pytest.raises(ValueError, match="not divisible"):
        g_step(g_state, {k: v[:6] for k, v in batch.items()})


def test_elastic_resume_on_remesh_is_bitwise(tmp_path):
    """Killed after step 2 on a (4, 2) grid, restored with
    ``restore(shardings=param_shardings(...))`` onto ``remesh(..., 1)``'s
    (4, 1) grid and onto no grid (``microbatches=4``): step 3 ends
    bitwise where the uninterrupted (4, 2) run ends."""
    cfg = tc.get_reduced("gemma3-1b").replace(dtype="float32", vocab=64)
    model, opt = t_build(cfg), TAdamW(lr=1e-3)
    state = ts.init_train_state(model, cfg, opt,
                                torch.Generator().manual_seed(0), device=CPU)
    mesh = grid(2, 8)
    data = SyntheticLM(vocab=64, seq_len=32, global_batch=8)
    batches = [{k: torch.from_numpy(v) for k, v in data.batch_at(i).items()}
               for i in range(3)]
    whole = placed(cfg, mesh, state)
    step = ts.make_grid_train_step(model, cfg, opt, mesh)
    for i, b in enumerate(batches):
        whole, _ = step(whole, b)
        if i == 1:
            tio.save(str(tmp_path / "ck"), whole, step=2)
    abstract = ts.init_train_state(model, cfg, opt, device="meta")
    survivors = te.remesh([CPU] * 4, model_parallel=1)
    assert survivors.shape == (4, 1)
    resumed, at = tio.restore(
        str(tmp_path / "ck"), abstract,
        shardings=tsh.param_shardings(cfg, survivors, abstract))
    assert at == 2
    resumed, _ = ts.make_grid_train_step(model, cfg, opt, survivors)(
        resumed, batches[2])
    assert tree_leaves(resumed)[0].mesh == survivors
    assert_trees_equal(resumed, whole)
    plain, _ = tio.restore(str(tmp_path / "ck"), state)
    plain, _ = ts.make_train_step(model, cfg, opt, microbatches=4)(
        plain, batches[2])
    assert_trees_equal(plain, whole)


def test_supervisor_restarts_a_grid_run_bitwise(tmp_path):
    """The launcher's ``train(mesh=)`` on a (2, 2) grid, crashed at step 3
    with a checkpoint every 2 steps, ends bitwise where the uninterrupted
    grid run and the unsharded ``microbatches=2`` run end."""
    from repro_torch.launch.train import train

    cfg = tc.get_reduced("alert-anytime-120m").replace(dtype="float32")
    kw = dict(steps=4, batch=4, seq=8, anytime=True, ckpt_every=2,
              device="cpu", log_every=0)
    mesh = grid(2, 4)
    runs = [train(cfg, ckpt_dir=str(tmp_path / name), mesh=m,
                  microbatches=mb, fail_at=fail, **kw)
            for name, m, mb, fail in (("grid", mesh, 1, None),
                                      ("crash", mesh, 1, 3),
                                      ("plain", None, 2, None))]
    for run in runs[:2]:
        assert all(isinstance(x, tm.GridShards)
                   for x in tree_leaves(run.state))
        assert_trees_equal(run.state, runs[2].state)
    # steps 0-2, the crash, then steps 2-3 again from the step-2 checkpoint
    assert runs[1].losses == runs[0].losses[:3] + runs[0].losses[2:]
    assert runs[0].end == runs[1].end == 4
