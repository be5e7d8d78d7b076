"""The port's RWKV-6 family against the JAX package on the CPU.

* ``rwkv_scan_plain`` (what the wrapper runs on CPU tensors) against the
  reference's Pallas ``rwkv_scan`` in interpret mode, as
  ``tests/test_kernels.py`` runs it, and against ``ref.rwkv_scan_ref``;
  lengths the Pallas kernel cannot chunk against ``ref`` only.  Tolerances
  as there: y float32 rtol = atol = 2e-5 (float32 throughout, sums in
  other orders), bf16 2e-2 (y is rounded to bf16 once, after float32
  sums in other orders); the float32 state 1e-4.
* The mixers, the reduced float32 model, its ``ServeEngine`` and a
  one-level ``FleetAlertServer`` against the reference on the same weights
  (the reference's init, carried over with ``params_from_jax``).  The
  reference's model never calls its own kernel: it runs the recurrence as
  ``_wkv_chunk_scan`` (S > 1, padded to whole chunks of ``rwkv_chunk``)
  or as an inline step (S == 1); the port serves on ``rwkv_scan`` for
  both.  Logits and states rtol = atol = 1e-5, as in
  ``tests/test_torch_model.py``.
* Training: the port's ``_wkv_chunk_scan`` (mode ``"train"``) against the
  reference's at whole and padded chunk counts (``TOL``), the train-mode
  mixers against the reference's, and the train forward's logits bitwise
  equal to the serving forward's on the CPU (the chunk scan repeats
  ``rwkv_scan_plain``'s operations); the per-chunk recompute leaves the
  gradients bitwise as they are without it; a serving forward that
  autograd would record still refuses.  The loss and gradients against
  ``jax.value_and_grad``: ``tests/test_torch_train_families.py``.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_3b as j_cfgs
from repro.core import batched as jb
from repro.core import controller as jc
from repro.kernels import ref
from repro.models import rwkv as j_rwkv
from repro.models import transformer as jt
from repro.models.common import layer_norm as j_layer_norm
from repro.models.registry import build_model as j_build
from repro.serving import alert_server as js
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import alert_anytime as t_anytime
from repro_torch.configs import rwkv6_3b as t_cfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import batched as tb
from repro_torch.core import controller as tc
from repro_torch.kernels import ops
from repro_torch.kernels import rwkv_scan as rs
from repro_torch.models import rwkv as t_rwkv
from repro_torch.models import transformer as tt
from repro_torch.models.common import layer_norm as t_layer_norm
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import alert_server as ts
from repro_torch.serving.engine import ServeEngine as TServeEngine

j_scan_mod = importlib.import_module("repro.kernels.rwkv_scan")

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT_LEN, N_DECODE, BATCH = 6, 3, 2


def scan_inputs(b, s, h, hd, seed):
    """float32 numpy inputs as tests/test_kernels.py draws them: r, k, v
    normal, w = sigmoid(normal) in (0, 1), u = sigmoid(normal) / 2, s0
    normal / 10."""
    rng = np.random.default_rng(seed)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    w = sig(rng.standard_normal((b, s, h, hd))).astype(np.float32)
    u = (sig(rng.standard_normal((h, hd))) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


def both(arrays, dtype_name):
    """The same inputs for the reference (jax) and the port (torch): r, k,
    v, w in ``dtype_name`` (both round float32 to bf16 to nearest even),
    u and s0 float32."""
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    j = [jnp.asarray(a).astype(jd) for a in arrays[:4]] + \
        [jnp.asarray(a) for a in arrays[4:]]
    t = [torch.from_numpy(a).to(td) for a in arrays[:4]] + \
        [torch.from_numpy(a) for a in arrays[4:]]
    return j, t


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


# --------------------------------------------------------------------- #
# rwkv_scan                                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hd,chunk", [
    (2, 64, 2, 16, 16),
    (1, 128, 4, 32, 32),
    (2, 32, 1, 64, 32),
])
def test_plain_matches_pallas_and_ref(dtype, b, s, h, hd, chunk):
    (jr, jk, jv, jw, ju, js0), t = both(scan_inputs(b, s, h, hd, s + hd),
                                        dtype)
    got_y, got_s = rs.rwkv_scan_plain(*t)
    assert got_y.dtype == getattr(torch, dtype)
    assert got_s.dtype == torch.float32
    pal_y, pal_s = j_scan_mod.rwkv_scan(jr, jk, jv, jw, ju, js0,
                                        chunk=chunk, interpret=True)
    ref_y, ref_s = ref.rwkv_scan_ref(jr, jk, jv, jw, ju, js0)
    for want_y, want_s in ((pal_y, pal_s), (ref_y, ref_s)):
        np.testing.assert_allclose(f32(got_y), f32(want_y), **TOL[dtype])
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   **STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 7, 20])
def test_plain_takes_any_length(dtype, s):
    """Lengths no chunk divides (the Pallas kernel raises on them):
    against ``ref`` only."""
    (jr, jk, jv, jw, ju, js0), t = both(scan_inputs(2, s, 2, 16, s), dtype)
    got_y, got_s = rs.rwkv_scan_plain(*t)
    ref_y, ref_s = ref.rwkv_scan_ref(jr, jk, jv, jw, ju, js0)
    np.testing.assert_allclose(f32(got_y), f32(ref_y), **TOL[dtype])
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s),
                               **STATE_TOL)
    if s == 20:
        with pytest.raises(ValueError, match="not divisible"):
            j_scan_mod.rwkv_scan(jr, jk, jv, jw, ju, js0, chunk=16,
                                 interpret=True)


def test_wrapper_runs_plain_on_cpu_and_reads_strides():
    """On CPU tensors the wrapper is the plain version (no launch
    counted); r/k/v/w given as views of ``[B,S,H*hd]`` (as the model's
    projections are) give the same result as contiguous copies."""
    arrays = scan_inputs(2, 9, 3, 16, 1)
    t = [torch.from_numpy(a) for a in arrays]
    before = rs.rwkv_scan.launches
    y, s_n = ops.rwkv_scan(*t)
    assert rs.rwkv_scan.launches == before
    py, ps = rs.rwkv_scan_plain(*t)
    assert torch.equal(y, py) and torch.equal(s_n, ps)
    flat = torch.cat([x.reshape(2, 9, 48) for x in t[:4]], dim=-1)
    views = [flat[..., i * 48:(i + 1) * 48].view(2, 9, 3, 16)
             for i in range(4)]
    assert not views[1].is_contiguous()
    vy, vs = rs.rwkv_scan(*views, t[4], t[5])
    assert torch.equal(vy, y) and torch.equal(vs, s_n)


def test_wrapper_rejects():
    r, k, v, w, u, s0 = (torch.from_numpy(a)
                         for a in scan_inputs(1, 4, 2, 16, 2))
    with pytest.raises(ValueError, match="head_dim 8"):
        rs.rwkv_scan(*(x[..., :8] for x in (r, k, v, w)), u[:, :8],
                     s0[..., :8, :8])
    with pytest.raises(ValueError, match="one shape"):
        rs.rwkv_scan(r, k[:, :3], v, w, u, s0)
    with pytest.raises(ValueError, match="float32"):
        rs.rwkv_scan(r, k, v, w, u.double(), s0)
    with pytest.raises(ValueError, match="one dtype"):
        rs.rwkv_scan(r, k.bfloat16(), v, w, u, s0)
    with pytest.raises(ValueError, match="s0"):
        rs.rwkv_scan(r, k, v, w, u, s0[:, :1])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        rs.rwkv_scan(*(x.to("meta") for x in (r, k, v, w, u, s0)))


def test_cost_of_a_2048_token_prompt():
    """The bound's work at (b) of the smoke: B=4, S=2048, H=40, hd=64 in
    float32 is about 425 MB and 6.8 GFLOP."""
    c = rs.rwkv_scan_cost(4, 2048, 40, 64, 4)
    tokens = 4 * 2048 * 40
    assert c["bytes_accessed"] == 5 * tokens * 64 * 4 + 4 * 40 * 64 + \
        2 * 4 * 4 * 40 * 64 * 64
    assert 4.2e8 < c["bytes_accessed"] < 4.3e8
    assert c["flops"] == tokens * (5 * 64 * 64 + 4 * 64)


# --------------------------------------------------------------------- #
# config, init, conversion                                               #
# --------------------------------------------------------------------- #
FIELDS = ("name", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab", "rwkv", "rwkv_head_dim",
          "rwkv_decay_lora", "rwkv_chunk", "nest_levels", "dtype",
          "norm_eps", "attn_chunk", "rope_theta")


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_config_matches_reference(which):
    j = j_cfgs.CONFIG if which == "CONFIG" else j_cfgs.reduced()
    t = t_cfgs.CONFIG if which == "CONFIG" else t_cfgs.reduced()
    for name in FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    assert t.rwkv_n_heads == j.rwkv_n_heads
    assert [t.mixer_kind(i) for i in range(t.n_layers)] == \
        [j.mixer_kind(i) for i in range(j.n_layers)]
    assert t.rwkv_chunk == j.rwkv_chunk


def test_config_rules():
    """An anytime config without nesting is a dense model the port runs
    (``tests/test_torch_dense.py``); fewer than one level is no config."""
    assert t_anytime.CONFIG.replace(nest_levels=1).mixer_kind(0) == "attn"
    with pytest.raises(ValueError, match="nest_levels"):
        t_anytime.CONFIG.replace(nest_levels=0)
    with pytest.raises(ValueError, match="without width nesting"):
        t_cfgs.CONFIG.replace(nest_levels=2)
    with pytest.raises(ValueError, match="rwkv heads"):
        t_cfgs.CONFIG.replace(rwkv_head_dim=48)


@pytest.fixture(scope="module")
def models():
    j_cfg = j_cfgs.reduced().replace(dtype="float32")
    t_cfg = t_cfgs.reduced().replace(dtype="float32")
    j_params = jt.init_lm(jax.random.PRNGKey(0), j_cfg)
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    return j_cfg, t_cfg, j_params, t_params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_shapes_and_dtypes_match_reference(dtype):
    """``init_lm``'s tensors: per layer the reference's names, shapes and
    dtypes (``decay_w0`` and ``bonus_u`` float32 in a bf16 model), an
    empty ``ffn``; the reference's init rules for the constant ones."""
    j_cfg = j_cfgs.reduced().replace(dtype=dtype)
    t_cfg = t_cfgs.reduced().replace(dtype=dtype)
    j_params = jax.tree.map(np.asarray,
                            jt.init_lm(jax.random.PRNGKey(0), j_cfg))
    t_params = tt.init_lm(t_cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    for name in ("embed", "unembed", "final_norm"):
        assert tuple(t_params[name].shape) == j_params[name].shape
        assert str(t_params[name].dtype).split(".")[1] == \
            str(j_params[name].dtype)
    stacked = j_params["group"]["pos0"]
    assert stacked["ffn"] == {}
    assert len(t_params["layers"]) == t_cfg.n_layers
    for layer in t_params["layers"]:
        assert layer["ffn"] == {}
        assert sorted(layer["mixer"]) == sorted(stacked["mixer"])
        for name, w in layer["mixer"].items():
            ref_w = stacked["mixer"][name]
            assert tuple(w.shape) == ref_w.shape[1:], name
            assert str(w.dtype).split(".")[1] == str(ref_w.dtype), name
            if name in ("norm", "cmix_norm", "ln_x_g", "mu_r", "mu_k",
                        "mu_v", "mu_g", "mu_w", "cmix_mu_k", "cmix_mu_r",
                        "decay_w0", "bonus_u", "ln_x_b"):
                np.testing.assert_array_equal(f32(w), f32(ref_w[0]))


def test_converted_params_and_real_size(models):
    """``params_from_jax`` unstacks the RWKV pytree; the tensors hold
    fewer parameters than ``param_count()`` reports (it counts a
    3 * d * d_ff FFN; RWKV's channel mix is 2 * d * d_ff + d * d)."""
    j_cfg, t_cfg, j_params, t_params = models
    stacked = j_params["group"]["pos0"]["mixer"]
    for li, layer in enumerate(t_params["layers"]):
        assert layer["ffn"] == {}
        for name, w in layer["mixer"].items():
            np.testing.assert_array_equal(w.numpy(),
                                          np.asarray(stacked[name][li]))
    n_torch = sum(p.numel() for p in [t_params["embed"],
                                      t_params["unembed"],
                                      t_params["final_norm"]]
                  + [w for layer in t_params["layers"]
                     for part in layer.values() for w in part.values()])
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(j_params))
    assert n_torch == n_jax < j_cfg.param_count()
    full = j_cfgs.CONFIG
    per_layer = sum(int(np.prod(s)) for s in
                    t_rwkv.rwkv_param_shapes(t_cfgs.CONFIG).values())
    real = full.n_layers * per_layer + 2 * full.vocab * full.d_model + \
        full.d_model
    assert 3.0e9 < real < 3.1e9 < 3.5e9 < full.param_count()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((5, 64), (64,), (64,)))
    want = j_layer_norm(*(jnp.asarray(a).astype(getattr(jnp, dtype))
                          for a in (x, g, b)))
    got = t_layer_norm(*(torch.from_numpy(a).to(getattr(torch, dtype))
                         for a in (x, g, b)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(f32(got), f32(want), **TOL[dtype])


# --------------------------------------------------------------------- #
# mixers                                                                 #
# --------------------------------------------------------------------- #
def random_state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    h, hd, d = cfg.rwkv_n_heads, cfg.rwkv_head_dim, cfg.d_model
    return (rng.standard_normal((b, h, hd, hd)).astype(np.float32) * 0.1,
            rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 20])
def test_mixers_match_reference(models, s, with_state):
    """S = 20 is no multiple of the reduced config's rwkv_chunk 16 (the
    reference pads); S = 1 is the reference's inline step."""
    j_cfg, t_cfg, j_params, t_params = models
    assert s == 1 or s % j_cfg.rwkv_chunk
    lp_j = jax.tree.map(lambda a: a[0], j_params["group"]["pos0"]["mixer"])
    lp_t = t_params["layers"][0]["mixer"]
    x = np.random.default_rng(s).standard_normal(
        (BATCH, s, t_cfg.d_model)).astype(np.float32)
    j_state = t_state = None
    if with_state:
        arrays = random_state(t_cfg, BATCH, s)
        j_state = j_rwkv.RwkvState(*map(jnp.asarray, arrays))
        t_state = t_rwkv.RwkvState(*map(torch.from_numpy, arrays))
    j_out, j_wkv, j_tail = j_rwkv.rwkv_time_mix(lp_j, jnp.asarray(x), j_cfg,
                                                state=j_state)
    t_out, t_wkv, t_tail = t_rwkv.rwkv_time_mix(lp_t, torch.from_numpy(x),
                                                t_cfg, state=t_state)
    for got, want in ((t_out, j_out), (t_wkv, j_wkv), (t_tail, j_tail)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)
    j_c, j_tc = j_rwkv.rwkv_channel_mix(lp_j, jnp.asarray(x), j_cfg,
                                        state=j_state)
    t_c, t_tc = t_rwkv.rwkv_channel_mix(lp_t, torch.from_numpy(x), t_cfg,
                                        state=t_state)
    for got, want in ((t_c, j_c), (t_tc, j_tc)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **MODEL_TOL)


def test_time_mix_launches_one_scan_per_call(models, monkeypatch):
    """Prefill and the decode step both go through ``rwkv_scan``."""
    _, t_cfg, _, t_params = models
    calls = []
    real = t_rwkv.rwkv_scan

    def spy(*args, **kwargs):
        calls.append(args[0].shape[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(t_rwkv, "rwkv_scan", spy)
    toks = torch.zeros((BATCH, 5), dtype=torch.long)
    out = tt.lm_apply(t_params, t_cfg, toks)
    tt.lm_apply(t_params, t_cfg, toks[:, :1], mode="decode",
                caches=out.caches, cache_len=5)
    assert calls == [5] * t_cfg.n_layers + [1] * t_cfg.n_layers


# --------------------------------------------------------------------- #
# training: the chunk scan                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("s,chunk", [(1, 1), (16, 16), (20, 16), (48, 16),
                                     (7, 3)])
def test_chunk_scan_matches_reference(s, chunk):
    """Whole chunks, a padded last chunk (k = 0, w = 1) and one token."""
    r, k, v, w, u, s0 = scan_inputs(2, s, 3, 16, seed=s)
    j_sn, j_y = j_rwkv._wkv_chunk_scan(*map(jnp.asarray, (s0, r, k, v, w,
                                                          u)), chunk)
    t_sn, t_y = t_rwkv._wkv_chunk_scan(*map(torch.from_numpy, (s0, r, k, v,
                                                               w, u)), chunk)
    assert t_y.shape == (2, s, 3, 16) and t_sn.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(t_y.numpy(), np.asarray(j_y),
                               **TOL["float32"])
    np.testing.assert_allclose(t_sn.numpy(), np.asarray(j_sn), **STATE_TOL)


@pytest.mark.parametrize("s", [1, 16, 20])
def test_train_mode_mixer_matches_reference(models, s):
    """``rwkv_time_mix(mode="train")`` (the chunk scan) against the
    reference's time mix from a zero state."""
    j_cfg, t_cfg, j_params, t_params = models
    lp_j = jax.tree.map(lambda a: a[0], j_params["group"]["pos0"]["mixer"])
    lp_t = t_params["layers"][0]["mixer"]
    x = np.random.default_rng(s).standard_normal(
        (BATCH, s, t_cfg.d_model)).astype(np.float32)
    want = j_rwkv.rwkv_time_mix(lp_j, jnp.asarray(x), j_cfg)
    got = t_rwkv.rwkv_time_mix(lp_t, torch.from_numpy(x), t_cfg,
                               mode="train")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **MODEL_TOL)


@pytest.mark.parametrize("s", [1, 16, 20])
def test_train_logits_equal_serving_logits(models, s):
    """On the CPU the train forward (the chunk scan, padded at S = 20) and
    the serving prefill (``rwkv_scan``'s plain version) run the same
    float32 operations: the logits are bitwise equal."""
    _, t_cfg, _, t_params = models
    toks = torch.from_numpy(np.random.default_rng(s).integers(
        0, t_cfg.vocab, (BATCH, s)))
    with torch.no_grad():
        train, _ = t_build(t_cfg).train_logits(t_params, {"tokens": toks})
        serve = tt.lm_apply(t_params, t_cfg, toks, mode="prefill").logits
    assert torch.equal(train, serve)


def test_train_mode_runs_no_kernel(models, monkeypatch):
    """Mode ``"train"`` never calls ``rwkv_scan``, whatever the backends."""
    _, t_cfg, _, t_params = models

    def refuse(*args, **kwargs):
        raise AssertionError("rwkv_scan called in mode 'train'")

    monkeypatch.setattr(t_rwkv, "rwkv_scan", refuse)
    toks = torch.zeros((BATCH, 5), dtype=torch.long)
    with torch.no_grad():
        out = tt.lm_apply(t_params, t_cfg, toks, mode="train")
    assert out.logits.shape == (BATCH, 5, t_cfg.vocab)


def test_chunk_recompute_keeps_gradients_bitwise(models, monkeypatch):
    """Each chunk under ``torch.utils.checkpoint`` gives the gradients of
    the same forward without the recompute, bit for bit."""
    from repro_torch.train.step import make_loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves

    _, t_cfg, _, t_params = models
    cfg = t_cfg.replace(remat=False)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, 20)))
             for k in ("tokens", "labels")}
    loss_fn = make_loss_fn(t_build(cfg), cfg)
    (loss, _), grads = value_and_grad(loss_fn, t_params, batch)
    monkeypatch.setattr(t_rwkv, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))
    (loss2, _), grads2 = value_and_grad(loss_fn, t_params, batch)
    assert torch.equal(loss, loss2)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads2)):
        assert torch.equal(a, b)


def test_recorded_serving_call_refuses(models):
    """A serving forward autograd would record reaches ``rwkv_scan``,
    which has no backward: it raises rather than lose the gradient."""
    _, t_cfg, _, t_params = models
    params = dict(t_params, layers=[
        {"mixer": {k: v.detach().requires_grad_(True)
                   for k, v in lp["mixer"].items()}, "ffn": {}}
        for lp in t_params["layers"]])
    toks = torch.zeros((BATCH, 5), dtype=torch.long)
    with torch.enable_grad(), pytest.raises(RuntimeError,
                                            match="rwkv_scan has no backward"):
        tt.lm_apply(params, t_cfg, toks, mode="prefill")


# --------------------------------------------------------------------- #
# model, engine, fleet server                                            #
# --------------------------------------------------------------------- #
def test_prefill_and_decode_match_reference(models):
    """Prefill logits and every RwkvState leaf, then 3 decode steps."""
    j_cfg, t_cfg, j_params, t_params = models
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    steps = rng.integers(0, t_cfg.vocab, (N_DECODE, BATCH, 1)).astype(
        np.int32)
    j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(prompt), mode="prefill")
    t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(prompt,
                                                         dtype=torch.long))

    def check(t_o, j_o):
        np.testing.assert_allclose(t_o.logits.numpy(),
                                   np.asarray(j_o.logits), **MODEL_TOL)
        j_states = j_o.caches["group"]["pos0"]
        assert len(t_o.caches) == t_cfg.n_layers
        for li, st in enumerate(t_o.caches):
            assert isinstance(st, t_rwkv.RwkvState)
            for got, want in zip(st, j_states):
                np.testing.assert_allclose(got.numpy(),
                                           np.asarray(want[li]),
                                           **MODEL_TOL)

    check(t_out, j_out)
    max_len = PROMPT_LEN + N_DECODE
    j_eng = JServeEngine(j_build(j_cfg), max_len=max_len, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=max_len, batch_size=BATCH,
                         device="cpu")
    assert j_eng.levels == t_eng.levels == [None]
    j_caches = j_eng._merge(j_eng.init_caches(None), j_out.caches)
    t_caches = t_out.caches
    for i, tok in enumerate(steps):
        j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(tok), mode="decode",
                            caches=j_caches,
                            cache_len=jnp.asarray(PROMPT_LEN + i, jnp.int32))
        t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(
            tok, dtype=torch.long), mode="decode", caches=t_caches,
            cache_len=PROMPT_LEN + i)
        check(t_out, j_out)
        j_caches, t_caches = j_out.caches, t_out.caches


def test_generate_matches_reference(models):
    j_cfg, t_cfg, j_params, t_params = models
    prompt = np.random.default_rng(11).integers(
        0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=16, batch_size=BATCH,
                         device="cpu")
    j_r = j_eng.generate(j_params, prompt, 6)
    t_r = t_eng.generate(t_params, prompt, 6)
    assert t_r["level"] is None and j_r["level"] is None
    assert t_r["complete"] and j_r["complete"]
    np.testing.assert_array_equal(t_r["tokens"], np.asarray(j_r["tokens"]))


STEP = 0.01           # fake seconds per clock read
GEN_TOKENS = 4        # a complete generate under a deadline: 0.04 s
RTOL = 1e-13


class SteppingClock:
    """Returns 0, STEP, 2*STEP, ... on successive calls."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return (self.n - 1) * STEP


TENANTS = [  # (goal, deadline, accuracy_goal, energy_goal)
    ("min", 0.05, 0.6, None), ("max", 0.05, None, 4.0),
    ("min", 0.035, 0.65, None), ("max", 0.045, None, 0.3),
    ("min", 0.08, 0.75, None),
]


def test_one_level_fleet_server_matches_reference(models):
    """The fleet server over the one-level model: profiled with fake
    clocks on both sides (one candidate, no anytime level, so only power
    adapts), then 5 ticks of Eq. 4 and Eq. 5 tenants with a retire and an
    admit; every served input equal (energy rtol 1e-13)."""
    j_cfg, t_cfg, j_params, t_params = models
    j_eng = JServeEngine(j_build(j_cfg), max_len=12, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=12, batch_size=BATCH,
                         device="cpu")
    j_eng.generate = functools.partial(j_eng.generate, clock=SteppingClock())
    t_eng.generate = functools.partial(t_eng.generate, clock=SteppingClock())
    kw = dict(level_accuracies=[0.7], n_streams=len(TENANTS),
              profile_iters=2, gen_tokens=GEN_TOKENS, prompt_len=4,
              start_active=False)
    j_srv = js.FleetAlertServer(j_eng, j_params,
                                goal=jc.Goal.MINIMIZE_ENERGY, **kw)
    t_srv = ts.FleetAlertServer(t_eng, t_params,
                                goal=tc.Goal.MINIMIZE_ENERGY, **kw)
    assert t_srv.scoring.backend == "torch"
    assert [dataclasses.asdict(c) for c in t_srv.table.candidates] == \
        [dataclasses.asdict(c) for c in j_srv.table.candidates]
    cand = t_srv.table.candidates[0]
    assert not cand.is_anytime_level and cand.anytime_group is None
    np.testing.assert_array_equal(t_srv.table.latency, j_srv.table.latency)
    np.testing.assert_array_equal(t_srv.table.run_power,
                                  j_srv.table.run_power)

    def admit(srv, mod, goal, deadline, ag, eg):
        g = mod.Goal.MINIMIZE_ENERGY if goal == "min" \
            else mod.Goal.MAXIMIZE_ACCURACY
        return srv.admit(g, mod.Constraints(deadline=deadline,
                                            accuracy_goal=ag,
                                            energy_goal=eg))

    for tenant in TENANTS:
        assert admit(j_srv, jc, *tenant) == admit(t_srv, tc, *tenant)
    prompts = [np.random.default_rng(s).integers(0, t_cfg.vocab, (2, 4))
               .astype(np.int32) for s in range(len(TENANTS))]
    caps_seen = set()
    for tick in range(5):
        if tick == 2:
            for srv, mod in ((j_srv, jc), (t_srv, tc)):
                srv.retire(1)
                assert admit(srv, mod, "max", 0.05, None, 1.0) == 1
        t_out = t_srv.serve_tick(prompts)
        j_out = j_srv.serve_tick(prompts)
        for t, j in zip(t_out, j_out):
            assert (t is None) == (j is None)
            if t is None:
                continue
            for f in ("level", "power_cap", "latency", "missed", "accuracy",
                      "feasible"):
                assert getattr(t, f) == getattr(j, f), (f, t, j)
            np.testing.assert_allclose(t.energy, j.energy, rtol=RTOL,
                                       atol=0)
            assert t.level == 0
            caps_seen.add(t.power_cap)
    assert any(o.missed for row in t_srv.history for o in row if o)
    assert len(caps_seen) > 1
    for name in ("mu", "sigma"):
        np.testing.assert_allclose(getattr(t_srv.slowdown, name).numpy(),
                                   np.asarray(getattr(j_srv.slowdown, name)),
                                   rtol=RTOL, atol=0)
    assert isinstance(t_srv.scoring, tb.BatchedAlertEngine)
    assert isinstance(j_srv.scoring, jb.BatchedAlertEngine)
