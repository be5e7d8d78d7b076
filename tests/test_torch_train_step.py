"""Three steps of the port's ``make_train_step`` against the reference's,
run with ``unroll_layers=True`` (so its AdamW decays the same leaves as
the port's, see ``test_torch_train.py``), from the reference's weights
carried with ``params_from_jax``, on the same synthetic batches: one
microbatch, two, and int8 compression, for the anytime LM's joint loss
(float32 and bfloat16), olmoe's loss with the aux term and qwen2-vl's
with ``pos3d`` split on its batch axis.

Tolerance, from the arithmetic and stated per check (the counts in
brackets are what the CPU gives): float32 in both, and the gradients
differ in the last bits (sums in other orders).  AdamW moves a parameter
by about ``lr * g / (|g| + eps)``, so where a gradient is rounding noise
(a key bias, which softmax makes gradient-free; an embedding row hit by
few tokens) the two runs step by noise, up to ``lr`` apart.  So after
three steps at peak lr 3e-3: at most 0.05 % of the float32 elements are
more than 2e-6 apart [0.002-0.019 %], and every one is within 0.1 lr
[0.075 lr]; the metrics within rtol 1e-5.  With compression, a gradient
on a rounding boundary of the int8 grid rounds to the neighbouring level
in one run, and that element's step differs by up to lr: at most 0.5 %
of the elements off [0.17 %], every one within 2 lr [1.02 lr]; the
metrics within rtol 1e-4.  In bfloat16 the forward and backward round
at other places (XLA keeps fusions in float32), so gradients differ by
bf16 ulps and small ones may flip sign: at most 2 % of the elements more
than one bf16 ulp apart [0.69 %], every one within one ulp and 2 lr a
step; the metrics within rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import SyntheticLM
from repro.models.registry import build_model as j_build
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as j_cosine
from repro.train import step as js
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model as t_build
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import cosine_schedule as t_cosine
from repro_torch.train import step as ts
from repro_torch.tree import tree_leaves
from tests.test_torch_train_grads import pair

STEPS, LR = 3, 3e-3


def run_both(arch, dtype="float32", microbatches=1, compress=False,
             anytime=False, pos3d=False):
    j_cfg, t_cfg, j_params, t_params = pair(arch)
    if dtype != "float32":
        j_cfg, t_cfg = j_cfg.replace(dtype=dtype), t_cfg.replace(dtype=dtype)
        j_params = jax.tree.map(lambda a: a.astype(dtype)
                                if a.dtype == jnp.float32 and a.ndim
                                else a, j_params)
        t_params = params_from_jax(jax.tree.map(np.asarray, j_params),
                                   t_cfg, device="cpu")
    jm, tm = j_build(j_cfg), t_build(t_cfg)
    j_opt = JAdamW(lr=j_cosine(LR, 1, STEPS))
    t_opt = TAdamW(lr=t_cosine(LR, 1, STEPS))
    j_loss = js.make_anytime_loss_fn(jm, j_cfg) if anytime else None
    t_loss = ts.make_anytime_loss_fn(tm, t_cfg) if anytime else None
    j_step = jax.jit(js.make_train_step(jm, j_cfg, j_opt,
                                        microbatches=microbatches,
                                        compress=compress, loss_fn=j_loss))
    t_step = ts.make_train_step(tm, t_cfg, t_opt, microbatches=microbatches,
                                compress=compress, loss_fn=t_loss)
    comp_j = comp_t = None
    if compress:
        from repro.optim.compress import init_compression as j_ic
        from repro_torch.optim.compress import init_compression as t_ic
        comp_j, comp_t = j_ic(j_params), t_ic(t_params)
    j_state = js.TrainState(j_params, j_opt.init(j_params), comp_j)
    t_state = ts.TrainState(t_params, t_opt.init(t_params), comp_t)
    data = SyntheticLM(vocab=t_cfg.vocab, seq_len=16, global_batch=4)
    for i in range(STEPS):
        batch = data.batch_at(i)
        if pos3d:
            t = np.broadcast_to(np.arange(16) // 4, (4, 16))
            batch["pos3d"] = np.stack([t, np.arange(16) % 4 + t,
                                       np.arange(16) % 2 + t]).astype(
                                           np.int32)
        j_state, j_met = j_step(j_state, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        t_state, t_met = t_step(t_state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        assert t_met.keys() == j_met.keys()
        rtol = 1e-3 if dtype != "float32" else 1e-4 if compress else 1e-5
        for k in j_met:
            np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                       rtol=rtol, atol=1e-7, err_msg=k)
    return j_cfg, t_cfg, j_state, t_state


def check_params(t_cfg, j_state, t_state, dtype="float32", compress=False):
    """Every parameter within the bound, and at most a share of them
    beyond the tight tolerance (see the module docstring)."""
    want = params_from_jax(jax.tree.map(np.asarray, j_state.params), t_cfg,
                           device="cpu")
    n = off = 0
    for a, b in zip(tree_leaves(t_state.params), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        a, b = a.double(), b.double()
        d = (a - b).abs()
        if dtype == "float32":
            tight = torch.full_like(b, 2e-6)
            bound = tight.new_full((), 2 * LR if compress else 0.1 * LR)
        else:     # one bf16 ulp of the reference's value
            tight = torch.exp2(torch.floor(torch.log2(b.abs())) - 7)
            tight = torch.where(b == 0, 0.0, tight)
            bound = tight + 2 * LR * STEPS
        assert bool((d <= bound).all()), float((d - bound).max())
        off += int((d > tight).sum())
        n += d.numel()
    share = 0.02 if dtype != "float32" else 0.005 if compress else 5e-4
    assert off <= share * n, (off, n)
    assert int(t_state.opt_state.step) == int(j_state.opt_state.step) \
        == STEPS


@pytest.mark.parametrize("microbatches,compress", [(1, False), (2, False),
                                                   (1, True), (2, True)])
def test_anytime_train_steps_match(microbatches, compress):
    _, t_cfg, j_state, t_state = run_both(
        "alert-anytime-120m", microbatches=microbatches, compress=compress,
        anytime=True)
    check_params(t_cfg, j_state, t_state, compress=compress)
    if compress:
        assert t_state.compress_state is not None
        for leaf in tree_leaves(t_state.compress_state.error):
            assert leaf.dtype == torch.float32


def test_anytime_train_steps_match_in_bfloat16():
    _, t_cfg, j_state, t_state = run_both("alert-anytime-120m",
                                          dtype="bfloat16", anytime=True)
    check_params(t_cfg, j_state, t_state, "bfloat16")
    for leaf in tree_leaves(t_state.opt_state.m):
        assert leaf.dtype == torch.float32


@pytest.mark.parametrize("arch,pos3d", [("olmoe-1b-7b", False),
                                        ("qwen2-vl-2b", True)])
def test_two_microbatches_match(arch, pos3d):
    _, t_cfg, j_state, t_state = run_both(arch, microbatches=2, pos3d=pos3d)
    check_params(t_cfg, j_state, t_state)


def test_microbatches_must_divide_the_batch():
    _, t_cfg, _, t_params = pair("alert-anytime-120m")
    model, opt = t_build(t_cfg), TAdamW()
    step = ts.make_train_step(model, t_cfg, opt, microbatches=3)
    state = ts.init_train_state(model, t_cfg, opt, params=t_params)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(t_cfg.vocab, 8, 4).batch_at(0).items()}
    with pytest.raises(ValueError, match="not divisible"):
        step(state, batch)


def test_one_microbatch_keeps_grads_in_param_dtype():
    _, t_cfg, _, t_params = pair("alert-anytime-120m")
    cfg = t_cfg.replace(dtype="bfloat16")
    params = {k: v for k, v in t_params.items()}
    params = ts.tree_map(lambda p: p.to(torch.bfloat16), params)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab, 8, 2).batch_at(0).items()}
    _, grads = ts.value_and_grad(
        ts.make_anytime_loss_fn(t_build(cfg), cfg), params, batch)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))
