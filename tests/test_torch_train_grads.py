"""The port's training forward and backward against the JAX reference on
the CPU: the loss and every gradient of ``make_anytime_loss_fn`` (joint,
weighted, greedy stage 2) against ``jax.value_and_grad`` of the
reference's (the other families: ``test_torch_train_families.py``), from
the reference's weights carried with ``params_from_jax``, in float32 at
the reduced sizes.  The
reference runs ``unroll_layers=True`` (one pytree leaf per layer, as the
port keeps them; the values are those of its layer scan).

Tolerance: float32 in both, but the products, softmax and the backward's
sums reduce in other orders; every gradient leaf is held to within 2e-5
of that leaf's largest magnitude (the largest seen is 6e-6, jamba's), the
loss to rtol 1e-6.

Also: remat off, ``"full"`` and ``"save_dots"`` give bitwise the same
loss and gradients (the recompute runs the same operations), and the
kernel backends refuse mode ``"train"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jc
from repro.models import transformer as jt
from repro.models import whisper as jw
from repro.models.registry import build_model as j_build
from repro.train import step as js
from repro_torch import configs as tc
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.train import step as ts
from repro_torch.tree import tree_leaves

B, S, FRAMES = 2, 16, 10
GRAD_TOL = 2e-5


def pair(arch, **kw):
    j_cfg = jc.get_reduced(arch).replace(dtype="float32", unroll_layers=True,
                                         **kw)
    t_cfg = tc.get_reduced(arch).replace(dtype="float32", **kw)
    init = jw.init_encdec if j_cfg.encoder_layers else jt.init_lm
    j_params = init(jax.random.PRNGKey(0), j_cfg)
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def make_batch(cfg, seed=0, pos3d=False, seq=S):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32)}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    if pos3d:       # three distinct streams, as an image's patches
        t = np.broadcast_to(np.arange(seq) // 4, (B, seq))
        batch["pos3d"] = np.stack([t, np.arange(seq) % 4 + t,
                                   np.arange(seq) % 2 + t]).astype(np.int32)
    return batch


def check_value_and_grad(j_cfg, t_cfg, j_params, t_params, j_loss_fn,
                         t_loss_fn, batch):
    (j_loss, j_met), j_grads = jax.jit(jax.value_and_grad(
        j_loss_fn, has_aux=True))(j_params,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
    (t_loss, t_met), t_grads = ts.value_and_grad(
        t_loss_fn, t_params, {k: torch.from_numpy(v) for k, v in
                              batch.items()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-6)
    assert t_met.keys() == j_met.keys()
    for k in j_met:
        np.testing.assert_allclose(float(t_met[k]), float(j_met[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, j_grads), t_cfg,
                           device="cpu")
    got_leaves, want_leaves = tree_leaves(t_grads), tree_leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(tree_leaves(t_params))
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= GRAD_TOL * scale + 1e-12
    return t_loss, t_grads


ANYTIME = [("joint", {}), ("weights", {"level_weights": [0.25, 0.3, 0.45]}),
           ("greedy2", {"greedy_stage": 2})]


@pytest.mark.parametrize("name,kw", ANYTIME, ids=[a for a, _ in ANYTIME])
def test_anytime_loss_and_grads_match(name, kw):
    j_cfg, t_cfg, j_params, t_params = pair("alert-anytime-120m")
    j_loss = js.make_anytime_loss_fn(j_build(j_cfg), j_cfg, **kw)
    t_loss = ts.make_anytime_loss_fn(t_build(t_cfg), t_cfg, **kw)
    check_value_and_grad(j_cfg, t_cfg, j_params, t_params, j_loss, t_loss,
                         make_batch(t_cfg))


def test_train_logits_levels_are_one_forward():
    """``all_levels`` gives every level's logits; each equals the
    truncated ``level=k`` forward (the nesting property)."""
    _, t_cfg, _, t_params = pair("alert-anytime-120m")
    model = t_build(t_cfg)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(t_cfg).items()}
    with torch.no_grad():
        every, aux = model.train_logits(t_params, batch, all_levels=True)
        assert float(aux) == 0.0 and len(every) == t_cfg.nest_levels
        for k, lg in enumerate(every, start=1):
            one, _ = model.train_logits(t_params, batch, level=k)
            np.testing.assert_allclose(one.numpy(), lg.numpy(), rtol=1e-5,
                                       atol=1e-5)
        prefill, _ = model.prefill(t_params, batch)
        assert torch.equal(prefill, every[-1])


@pytest.mark.parametrize("arch", ["alert-anytime-120m", "olmoe-1b-7b",
                                  "whisper-tiny"])
def test_remat_policies_give_the_same_gradients(arch):
    _, t_cfg, _, t_params = pair(arch)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(t_cfg).items()}
    results = []
    for cfg in (t_cfg.replace(remat=False), t_cfg.replace(remat=True),
                t_cfg.replace(remat=True, remat_policy="save_dots")):
        model = t_build(cfg)
        loss_fn = ts.make_anytime_loss_fn(model, cfg) \
            if cfg.nest_levels > 1 else ts.make_loss_fn(model, cfg)
        results.append(ts.value_and_grad(loss_fn, t_params, batch))
    (l0, _), g0 = results[0]
    for (loss, _), grads in results[1:]:
        assert torch.equal(loss, l0)
        for a, b in zip(tree_leaves(grads), tree_leaves(g0)):
            assert torch.equal(a, b)


def test_remat_keeps_fewer_activations():
    """Under remat a layer's activations are not kept for the backward:
    the autograd graph holds fewer saved tensors."""
    _, t_cfg, _, t_params = pair("alert-anytime-120m")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(t_cfg).items()}
    counts = {}
    for remat in (False, True):
        cfg = t_cfg.replace(remat=remat)
        n = [0]

        def pack(t):
            n[0] += 1
            return t

        live = {k: v for k, v in t_params.items()}
        live["embed"] = t_params["embed"].clone().requires_grad_(True)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            t_build(cfg).train_logits(live, batch, all_levels=True)
        counts[remat] = n[0]
    assert counts[True] < counts[False]


@pytest.mark.parametrize("kw", [{"nest_backend": "kernel"},
                                {"attn_backend": "kernel"}])
def test_kernel_backends_refuse_train_mode(kw):
    _, t_cfg, _, t_params = pair("alert-anytime-120m")
    cfg = t_cfg.replace(**kw)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(t_cfg).items()}
    with pytest.raises(ValueError, match="mode 'train' runs no kernel"):
        t_build(cfg).train_logits(t_params, batch)
    with pytest.raises(ValueError, match="mode 'train' runs no kernel"):
        ts.value_and_grad(ts.make_anytime_loss_fn(t_build(cfg), cfg),
                          t_params, batch)


def test_whisper_kernel_backend_refuses_train_mode():
    _, t_cfg, _, t_params = pair("whisper-tiny")
    cfg = t_cfg.replace(attn_backend="kernel")
    batch = {k: torch.from_numpy(v) for k, v in make_batch(cfg).items()}
    with pytest.raises(ValueError, match="mode 'train' runs no kernel"):
        t_build(cfg).train_logits(t_params, batch)


def test_serving_forward_is_unchanged_by_train_fields():
    """A prefill reads none of the training fields and returns no aux."""
    _, t_cfg, _, t_params = pair("olmoe-1b-7b")
    toks = torch.from_numpy(make_batch(t_cfg)["tokens"])
    with torch.inference_mode():
        a = tt.lm_apply(t_params, t_cfg, toks)
        b = tt.lm_apply(t_params, t_cfg.replace(remat=False, loss_chunk=4,
                                                router_aux_weight=1.0), toks)
    assert torch.equal(a.logits, b.logits) and a.aux_loss is None
