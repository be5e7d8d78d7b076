"""The port's width-nested anytime LM against the JAX reference on the
CPU: ``alert-anytime-120m``'s ``reduced()`` config in float32, weights
initialised by the reference and carried over with ``params_from_jax``.

Tolerance: float32 in both frameworks, but matrix products, cumulative
sums and softmax reduce in different orders, so logits agree to about
1e-6; the tests hold them to rtol = atol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import alert_anytime as j_cfgs
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import alert_anytime as t_cfgs
from repro_torch.convert import params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving.engine import ServeEngine as TServeEngine

TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT_LEN, N_DECODE, BATCH = 6, 4, 2


@pytest.fixture(scope="module")
def models():
    j_cfg = j_cfgs.reduced().replace(dtype="float32")
    t_cfg = t_cfgs.reduced().replace(dtype="float32")
    j_params = jt.init_lm(jax.random.PRNGKey(0), j_cfg)
    np_params = jax.tree.map(np.asarray, j_params)
    t_params = params_from_jax(np_params, t_cfg, device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def test_configs_and_converted_shapes(models):
    j_cfg, t_cfg, j_params, t_params = models
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
                 "d_ff", "vocab", "nest_levels", "attn_chunk", "norm_eps",
                 "rope_theta", "nest_backend"):
        assert getattr(t_cfg, name) == getattr(j_cfg, name), name
        assert getattr(t_cfgs.CONFIG, name) == getattr(j_cfgs.CONFIG, name)
    assert len(t_params["layers"]) == t_cfg.n_layers
    stacked = j_params["group"]["pos0"]["mixer"]["wq"]
    for li, layer in enumerate(t_params["layers"]):
        assert np.array_equal(layer["mixer"]["wq"].numpy(),
                              np.asarray(stacked[li]))
    n = sum(p.numel() for p in [t_params["embed"], t_params["unembed"],
                                t_params["final_norm"]]
            + [w for layer in t_params["layers"]
               for part in layer.values() for w in part.values()])
    assert n == j_cfg.param_count()


@pytest.mark.parametrize("level", [1, 2, 3])
def test_prefill_and_decode_logits_match(models, level):
    j_cfg, t_cfg, j_params, t_params = models
    rng = np.random.default_rng(level)
    prompt = rng.integers(0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    steps = rng.integers(0, t_cfg.vocab, (N_DECODE, BATCH, 1)).astype(
        np.int32)
    max_len = PROMPT_LEN + N_DECODE
    j_eng = JServeEngine(j_build(j_cfg), max_len=max_len, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=max_len, batch_size=BATCH,
                         device="cpu")

    j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(prompt),
                        mode="prefill", level=level)
    with torch.inference_mode():
        t_out = tt.lm_apply(t_params, t_cfg, torch.from_numpy(prompt).long(),
                            mode="prefill", level=level)
        if level == t_cfg.nest_levels:   # the registry API runs the top level
            logits, _ = t_build(t_cfg).prefill(
                t_params, {"tokens": torch.from_numpy(prompt).long()})
            assert torch.equal(logits, t_out.logits)
    np.testing.assert_allclose(t_out.logits.numpy(), np.asarray(j_out.logits),
                               **TOL)
    j_caches = j_eng._merge(j_eng.init_caches(level), j_out.caches)
    t_caches = t_eng._merge(t_eng.init_caches(level), t_out.caches)
    for i in range(N_DECODE):
        j_o = jt.lm_apply(j_params, j_cfg, jnp.asarray(steps[i]),
                          mode="decode", caches=j_caches,
                          cache_len=jnp.asarray(PROMPT_LEN + i, jnp.int32),
                          level=level)
        j_caches = j_o.caches
        with torch.inference_mode():
            t_o = tt.lm_apply(t_params, t_cfg,
                              torch.from_numpy(steps[i]).long(),
                              mode="decode", caches=t_caches,
                              cache_len=PROMPT_LEN + i, level=level)
        t_caches = t_o.caches
        np.testing.assert_allclose(t_o.logits.numpy(),
                                   np.asarray(j_o.logits), **TOL)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_generate_tokens_equal(models, level):
    j_cfg, t_cfg, j_params, t_params = models
    prompt = np.random.default_rng(10 + level).integers(
        0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=16, batch_size=BATCH,
                         device="cpu")
    j_r = j_eng.generate(j_params, prompt, 5, level=level)
    t_r = t_eng.generate(t_params, prompt, 5, level=level)
    assert t_r["tokens"].dtype == np.int32
    np.testing.assert_array_equal(t_r["tokens"], j_r["tokens"])
    assert t_r["complete"] and t_r["level"] == level


def test_level_caches_sized_to_level_kv_width(models):
    _, t_cfg, _, _ = models
    eng = TServeEngine(t_build(t_cfg), max_len=8, batch_size=1, device="cpu")
    for level in eng.levels:
        caches = eng.init_caches(level)
        assert len(caches) == t_cfg.n_layers
        assert caches[0].k.shape == (1, 8, 2 ** (level - 1) * 2, 8)


def test_port_init_is_seeded_and_shaped():
    cfg = t_cfgs.reduced()
    a = tt.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = tt.init_lm(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["layers"][1]["ffn"]["w_down"],
                       b["layers"][1]["ffn"]["w_down"])
    assert a["layers"][0]["mixer"]["wo"].shape == (64, 64)
    assert a["unembed"].shape == (64, 256)


def test_top_level_decode_step_through_registry(models):
    j_cfg, t_cfg, j_params, t_params = models
    prompt = np.random.default_rng(4).integers(
        0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(np.int32)
    nxt = np.full((BATCH, 1), 7, np.int32)
    model = t_build(t_cfg)
    with torch.inference_mode():
        _, pre = model.prefill(t_params,
                               {"tokens": torch.from_numpy(prompt).long()})
        caches = model.init_caches(BATCH, PROMPT_LEN + 1, device="cpu")
        caches = TServeEngine._merge(caches, pre)
        got, _ = model.decode_step(
            t_params, {"tokens": torch.from_numpy(nxt).long(),
                       "cache_len": PROMPT_LEN}, caches)
    full = jt.lm_apply(j_params, j_cfg,
                       jnp.asarray(np.concatenate([prompt, nxt], 1)),
                       mode="prefill").logits
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(full[:, -1]),
                               **TOL)


def test_rms_norm_and_rope_match():
    from repro.models import common as jcom
    from repro_torch.models import common as tcom

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1))
    np.testing.assert_allclose(
        tcom.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jcom.rms_norm(jnp.asarray(x), jnp.asarray(g))), **TOL)
    np.testing.assert_allclose(
        tcom.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        1e4).numpy(),
        np.asarray(jcom.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)),
        **TOL)
    assert np.array_equal(tcom.rope_freqs(16, 1e4), jcom.rope_freqs(16, 1e4))
