"""The port's training building blocks against the JAX reference on the
CPU: the synthetic data, the losses, the training parts of
``core/nesting.py``, AdamW and its schedule, gradient compression, the
config's training fields, and the kernels' refusal of gradients.

Tolerances: the data, the one-hot weights, the depth plans and the
compression (the same float32 operations in the same order) are
compared bitwise.  Losses and AdamW run float32 operations whose sums
(``log_softmax``, ``mean``, the global norm) reduce in another order in
each framework, and the reference's ``pow``/``cos`` are XLA's own: they
are held to rtol 1e-6 (a few float32 ulps).  A bfloat16 parameter is
rounded from such a float32 value, so it may land one bf16 ulp away: held
to rtol 2**-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import nesting as jn
from repro.data import synthetic as jd
from repro.optim import adamw as ja
from repro.optim import compress as jcomp
from repro.train import losses as jl
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.core import nesting as tn
from repro_torch.data import synthetic as td
from repro_torch.kernels import alert_select as ks
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import nested_matmul as knm
from repro_torch.kernels import rwkv_scan as krs
from repro_torch.optim import adamw as ta
from repro_torch.optim import compress as tcomp
from repro_torch.train import losses as tl

F32 = dict(rtol=1e-6, atol=1e-7)


def np_of(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


# --------------------------------------------------------------------- #
# data/synthetic.py                                                      #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("step,host,n_hosts", [(0, 0, 1), (7, 0, 1),
                                               (123, 1, 2), (5, 3, 4)])
def test_synthetic_batches_bitwise(order, step, host, n_hosts):
    kw = dict(vocab=97, seq_len=33, global_batch=8, noise=0.2, seed=11,
              order=order)
    got = td.SyntheticLM(**kw).batch_at(step, host, n_hosts)
    want = jd.SyntheticLM(**kw).batch_at(step, host, n_hosts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_iterator_and_refusals():
    t, j = td.SyntheticLM(32, 8, 4), jd.SyntheticLM(32, 8, 4)
    assert t.optimal_accuracy() == j.optimal_accuracy()
    ti, ji = td.token_iterator(t, 3, 1, 2), jd.token_iterator(j, 3, 1, 2)
    for _ in range(3):
        (ts, tb), (js, jb) = next(ti), next(ji)
        assert ts == js
        np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    with pytest.raises(ValueError, match="divide"):
        t.batch_at(0, 0, 3)


# --------------------------------------------------------------------- #
# train/losses.py                                                        #
# --------------------------------------------------------------------- #
def logits_labels(seed, b=2, s=12, v=50):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, v)).astype(np.float32) * 3,
            rng.integers(0, v, (b, s)).astype(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_entropy_matches(dtype):
    lg, lab = logits_labels(0)
    jlg = jnp.asarray(lg).astype(dtype)
    tlg = torch.from_numpy(lg).to(getattr(torch, dtype))
    np.testing.assert_allclose(
        np_of(tl.cross_entropy(tlg, torch.from_numpy(lab))),
        np.asarray(jl.cross_entropy(jlg, jnp.asarray(lab))), **F32)


@pytest.mark.parametrize("chunk", [1, 4, 12, 64])
def test_chunked_cross_entropy_matches(chunk):
    rng = np.random.default_rng(chunk)
    h = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    lab = rng.integers(0, 40, (2, 12)).astype(np.int32)
    got = tl.chunked_cross_entropy(torch.from_numpy(h), torch.from_numpy(w),
                                   torch.from_numpy(lab), chunk)
    want = jl.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                    jnp.asarray(lab), chunk)
    np.testing.assert_allclose(np_of(got), np.asarray(want), **F32)
    whole = tl.cross_entropy(torch.from_numpy(h) @ torch.from_numpy(w),
                             torch.from_numpy(lab))
    np.testing.assert_allclose(np_of(got), np_of(whole), **F32)


def test_chunked_cross_entropy_needs_whole_chunks():
    h = torch.zeros(1, 10, 4)
    with pytest.raises(ValueError, match="not divisible"):
        tl.chunked_cross_entropy(h, torch.zeros(4, 3),
                                 torch.zeros(1, 10, dtype=torch.int32), 4)


def test_token_accuracy_takes_the_first_of_tied_maxima():
    lg, lab = logits_labels(3, v=6)
    lg = np.round(lg)                   # ties among the maxima
    lab[0, :3] = np.argmax(lg[0, :3], axis=-1)
    got = tl.token_accuracy(torch.from_numpy(lg), torch.from_numpy(lab))
    want = jl.token_accuracy(jnp.asarray(lg), jnp.asarray(lab))
    assert got.dtype == torch.float32
    # the reference's mean multiplies by 1/n (XLA), the port's divides
    np.testing.assert_allclose(float(got), float(want), **F32)


# --------------------------------------------------------------------- #
# core/nesting.py: the training parts                                    #
# --------------------------------------------------------------------- #
SPECS = [(tn.StripeSpec.pow2(16, 3), jn.StripeSpec.pow2(16, 3),
          tn.StripeSpec.pow2(32, 3), jn.StripeSpec.pow2(32, 3)),
         (tn.StripeSpec.pow2(32, 4), jn.StripeSpec.pow2(32, 4),
          tn.StripeSpec.saturated(8, 4), jn.StripeSpec.saturated(8, 4))]


@pytest.mark.parametrize("specs", SPECS, ids=["pow2", "saturated"])
def test_slice_and_freeze_prefix(specs):
    ti, ji, to, jo = specs
    rng = np.random.default_rng(0)
    w = rng.standard_normal((ti.total, to.total)).astype(np.float32)
    x = rng.standard_normal((3, ti.total)).astype(np.float32)
    for level in range(1, ti.levels + 1):
        np.testing.assert_array_equal(
            tn.slice_linear_to_level(torch.from_numpy(w), ti, to,
                                     level).numpy(),
            np.asarray(jn.slice_linear_to_level(jnp.asarray(w), ji, jo,
                                                level)))
        # forward unchanged, gradient zero on the frozen block: as
        # jax.grad through stop_gradient
        tw = torch.from_numpy(w).requires_grad_(True)
        fw = tn.freeze_prefix(tw, ti, to, level)
        np.testing.assert_array_equal(fw.detach().numpy(), w)
        (torch.from_numpy(x) @ fw).square().sum().backward()
        jg = jax.grad(lambda ww: jnp.sum(jnp.square(
            jnp.asarray(x) @ jn.freeze_prefix(ww, ji, jo, level))))(
                jnp.asarray(w))
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg),
                                   rtol=1e-5, atol=1e-5)
        if level > 1:
            di = ti.width(min(level - 1, ti.levels))
            do = to.width(level - 1)
            assert not tw.grad[:di, :do].any()
            if do < to.total:     # a saturated dim is wholly frozen
                assert tw.grad[:, do:].abs().sum() > 0


def test_joint_anytime_loss_and_greedy_weights():
    losses = [np.float32(v) for v in (2.5, 1.75, 1.2)]
    for weights in (None, [0.25, 0.3, 0.45], [0.0, 1.0, 0.0]):
        got = tn.joint_anytime_loss([torch.tensor(v) for v in losses],
                                    weights)
        want = jn.joint_anytime_loss([jnp.asarray(v) for v in losses],
                                     weights)
        assert got.dtype == torch.float32
        assert np_of(got) == np.asarray(want)
    with pytest.raises(ValueError):
        tn.joint_anytime_loss([torch.tensor(1.0)], [0.5, 0.5])
    for stage in range(1, 5):
        assert tn.greedy_stage_weights(stage, 4) == \
            jn.greedy_stage_weights(stage, 4)
    assert tl.joint_anytime_loss is tn.joint_anytime_loss


@pytest.mark.parametrize("n_layers,levels", [(1, 1), (4, 2), (8, 3),
                                             (12, 4), (7, 3)])
def test_depth_spec_matches(n_layers, levels):
    t, j = tn.DepthSpec(n_layers, levels), jn.DepthSpec(n_layers, levels)
    for i in range(n_layers):
        assert t.level_of_layer(i) == j.level_of_layer(i)
        assert t.skip_sources(i) == j.skip_sources(i)
    for lv in range(1, levels + 1):
        assert t.layers_of_level(lv) == j.layers_of_level(lv)


@pytest.mark.parametrize("level", [None, 1, 2, 3])
def test_depth_nested_apply_matches(level):
    n, levels, d = 8, 3, 5
    rng = np.random.default_rng(1)
    ws = rng.standard_normal((n, d, d)).astype(np.float32) / 3
    x = rng.standard_normal((2, d)).astype(np.float32)
    t_fns = [lambda h, w=torch.from_numpy(w): torch.tanh(h @ w) for w in ws]
    j_fns = [lambda h, w=jnp.asarray(w): jnp.tanh(h @ w) for w in ws]
    got = tn.depth_nested_apply(t_fns, torch.from_numpy(x),
                                tn.DepthSpec(n, levels), level)
    want = jn.depth_nested_apply(j_fns, jnp.asarray(x),
                                 jn.DepthSpec(n, levels), level)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    if level is not None and level < levels:    # a prefix of the full run
        full = tn.depth_nested_apply(t_fns, torch.from_numpy(x),
                                     tn.DepthSpec(n, levels))
        for a, b in zip(got, full):
            assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# optim/adamw.py                                                         #
# --------------------------------------------------------------------- #
def adamw_trees(seed, dtype, grad_scale):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (6, 4), "layers": [{"norm": (4,), "w": (4, 3)}],
              "bias": (3,)}

    def make(scale):
        out = {"embed": rng.standard_normal(shapes["embed"]) * scale,
               "layers": [{"norm": rng.standard_normal(4) * scale,
                           "w": rng.standard_normal((4, 3)) * scale}],
               "bias": rng.standard_normal(3) * scale}
        return jax.tree.map(lambda a: a.astype(np.float32), out)

    params = make(1.0)
    grads = [make(grad_scale) for _ in range(3)]
    to_t = lambda tree: jax.tree.map(
        lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), tree)
    to_j = lambda tree: jax.tree.map(
        lambda a: jnp.asarray(a).astype(dtype), tree)
    return to_t(params), to_j(params), [to_t(g) for g in grads], \
        [to_j(g) for g in grads]


def assert_tree_close(got, want, dtype):
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np_of, got)),
                    jax.tree.leaves(jax.tree.map(
                        lambda x: np.asarray(x, np.float32), want))):
        np.testing.assert_allclose(a, b, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0],
                         ids=["unclipped", "clipped"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_three_steps_match(dtype, grad_scale, schedule):
    tp, jp, tgs, jgs = adamw_trees(0, dtype, grad_scale)
    lr_t = ta.cosine_schedule(3e-2, 1, 3) if schedule else 3e-2
    lr_j = ja.cosine_schedule(3e-2, 1, 3) if schedule else 3e-2
    topt, jopt = ta.AdamW(lr=lr_t), ja.AdamW(lr=lr_j)
    ts, js = topt.init(tp), jopt.init(jp)
    for tg, jg in zip(tgs, jgs):
        tp, ts, tm = topt.update(tg, ts, tp)
        jp, js, jm = jopt.update(jg, js, jp)
        assert_tree_close(tp, jp, dtype)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(np_of(tm[k]), np.asarray(jm[k]),
                                       **F32)
        assert int(ts.step) == int(js.step)
    assert_tree_close(ts.m, js.m, "float32")
    assert_tree_close(ts.v, js.v, "float32")
    for leaf in jax.tree.leaves(ts.m) + jax.tree.leaves(ts.v):
        assert leaf.dtype == torch.float32
    for leaf in jax.tree.leaves(tp):
        assert leaf.dtype == getattr(torch, dtype)


def test_adamw_decays_by_each_leafs_rank():
    """With zero gradients the Adam direction is 0: only the decay moves a
    parameter, so leaves of two or more dims shrink by lr * wd and norms
    and biases stay, as the reference's rule says."""
    p = {"w": torch.ones(2, 3), "norm": torch.ones(3), "b": torch.ones(3)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    opt = ta.AdamW(lr=0.5, weight_decay=0.1)
    new, _, _ = opt.update(g, opt.init(p), p)
    np.testing.assert_allclose(new["w"].numpy(), np.full((2, 3), 0.95),
                               rtol=1e-7)
    assert torch.equal(new["norm"], p["norm"])
    assert torch.equal(new["b"], p["b"])


def test_reference_decays_stacked_norms_unless_unrolled():
    """The reference gap the port does not copy: its layer scan stacks a
    period's norms to ``[n_repeats, d]``, which its ``ndim >= 2`` rule
    then decays; under ``unroll_layers=True`` each layer's norm is 1-D
    and is not decayed."""
    from repro.configs.alert_anytime import reduced
    from repro.models import transformer as jt

    opt = ja.AdamW(lr=0.5, weight_decay=0.1)
    for unroll, decayed in ((False, True), (True, False)):
        cfg = reduced().replace(dtype="float32", unroll_layers=unroll)
        params = jt.init_lm(jax.random.PRNGKey(0), cfg)
        grads = jax.tree.map(jnp.zeros_like, params)
        new, _, _ = opt.update(grads, opt.init(params), params)
        norm = (new["group"]["pos0"] if not unroll else new["rem0"])[
            "mixer"]["norm"]
        assert norm.ndim == (2 if not unroll else 1)
        assert bool(jnp.all(norm < 1.0)) == decayed
        np.testing.assert_array_equal(np.asarray(new["final_norm"]),
                                      np.asarray(params["final_norm"]))


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 30), (5, 5)])
def test_cosine_schedule_matches(warmup, total):
    t = ta.cosine_schedule(3e-3, warmup, total)
    j = ja.cosine_schedule(3e-3, warmup, total)
    for step in range(total + 3):
        got = t(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(np_of(got), np.asarray(j(step)), **F32)
        assert np_of(t(step)) == np_of(got)


def test_global_norm_matches():
    _, jp, tgs, jgs = adamw_trees(2, "float32", 1.0)
    np.testing.assert_allclose(np_of(ta.global_norm(tgs[0])),
                               np.asarray(ja.global_norm(jgs[0])), **F32)


# --------------------------------------------------------------------- #
# optim/compress.py                                                      #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_grads_three_steps_bitwise(dtype):
    tp, jp, tgs, jgs = adamw_trees(4, dtype, 1.0)
    ts, js = tcomp.init_compression(tp), jcomp.init_compression(jp)
    for tg, jg in zip(tgs, jgs):
        tq, ts, tm = tcomp.compress_grads(tg, ts)
        jq, js, jm = jcomp.compress_grads(jg, js)
        for a, b in zip(jax.tree.leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(np_of(a),
                                          np.asarray(b, np.float32))
        for a, b in zip(jax.tree.leaves(ts.error),
                        jax.tree.leaves(js.error)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(np_of(tm["compress_err"]),
                                   np.asarray(jm["compress_err"]), **F32)


def test_quantize_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q, scale = tcomp.quantize_int8(x)
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x.numpy()))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert np_of(scale) == np.asarray(jscale)


# --------------------------------------------------------------------- #
# configs/base.py: the training fields                                   #
# --------------------------------------------------------------------- #
def test_training_fields_match_the_reference():
    kw = dict(name="x", family="dense", n_layers=1, d_model=8, n_heads=1,
              n_kv_heads=1, head_dim=8, d_ff=8, vocab=8)
    t, j = TConfig(**kw), JConfig(**kw)
    for name in ("remat", "remat_policy", "loss_chunk",
                 "router_aux_weight"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.replace(remat_policy="save_dots").remat_policy == "save_dots"
    with pytest.raises(ValueError, match="remat_policy"):
        t.replace(remat_policy="dots")


# --------------------------------------------------------------------- #
# the kernels refuse gradients                                           #
# --------------------------------------------------------------------- #
def wrapper_calls():
    spec = tn.StripeSpec.pow2(16, 2)
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    q, k, v = r(2, 4, 2, 8), r(2, 4, 2, 8), r(2, 4, 2, 8)
    return {
        "nested_matmul": (lambda x, w: knm.nested_matmul(x, w, spec, spec),
                          (r(3, 16), r(16, 16))),
        "flash_attention": (lambda q, k, v: kfa.flash_attention(q, k, v),
                            (q, k, v)),
        "decode_attention": (lambda q, k, v: kda.decode_attention(
            q[:, 0], k, v, 3), (q, k, v)),
        "rwkv_scan": (lambda r_, k_, v_, w_, u, s0: krs.rwkv_scan(
            r_, k_, v_, w_, u, s0),
            (r(1, 3, 2, 16), r(1, 3, 2, 16), r(1, 3, 2, 16),
             torch.rand(1, 3, 2, 16, generator=g), r(2, 16),
             r(1, 2, 16, 16))),
    }


@pytest.mark.parametrize("name", ["nested_matmul", "flash_attention",
                                  "decode_attention", "rwkv_scan"])
def test_kernel_wrappers_refuse_recorded_calls(name):
    """A wrapper raises while autograd would record it (any floating
    input requiring a gradient), on the CPU as on the card; the same call
    without gradients, or under no_grad, runs the plain version."""
    fn, args = wrapper_calls()[name]
    plain = fn(*args)
    for i in range(len(args)):
        live = [a.clone().requires_grad_(j == i) for j, a in
                enumerate(args)]
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            fn(*live)
        with torch.no_grad():
            got = fn(*live)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        plain if isinstance(plain, tuple) else (plain,)):
            assert torch.equal(a, b)


def test_plain_versions_take_gradients():
    spec = tn.StripeSpec.pow2(16, 2)
    x = torch.randn(3, 16, requires_grad=True)
    knm.nested_matmul_plain(x, torch.randn(16, 16), spec, spec,
                            2).sum().backward()
    assert x.grad is not None and x.grad.abs().sum() > 0
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    kfa.flash_attention_plain(q, q.detach(), q.detach()).sum().backward()
    assert q.grad is not None


def test_alert_select_is_not_guarded():
    """The scoring kernel takes no gradient, so it has no guard: its
    wrapper does not call the check."""
    import inspect

    assert "no_backward" not in inspect.getsource(ks)
    for mod in (knm, kfa, kda, krs):
        assert "no_backward(" in inspect.getsource(mod)
