"""The port's vision-language decoder (``qwen2-vl-2b``, M-RoPE) and the two
flags of ``lm_apply`` that PR 18 left, ``tie_embeddings`` and
``prefill_last_only``, against the JAX package on the CPU.

``apply_mrope`` against the reference's with three distinct position
streams and with three equal ones (then equal to ``apply_rope``), and its
section check; reduced ``qwen2-vl-2b`` in float32 with the reference's
weights (q/k/v biases overwritten with seeded non-zero values, which the
reference initialises to zero) in both attention backends: prefill and 3
decode steps with ``pos3d`` (``[3, B, S]``, then ``[3, B, 1]``), with
``embeds`` in place of the tokens, and text-only (no ``pos3d``: plain
RoPE, as the serving engine runs it); the engine's greedy tokens; the
full config's size.  ``tie_embeddings`` (no ``unembed``: logits through
``embed.T``) and ``prefill_last_only`` (a prefill's logits at the last
position only) on reduced ``qwen2.5-14b``.

Tolerance: float32 on both sides, products and softmax summed in other
orders, so outputs agree to about 2e-6; the tests hold them to rtol = atol
= 1e-5, as ``tests/test_torch_dense.py`` does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import common as j_common
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import common as t_common
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving.engine import ServeEngine as TServeEngine

ARCH = "qwen2-vl-2b"
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT_LEN, N_DECODE, BATCH = 12, 3, 2
MAX_LEN = PROMPT_LEN + N_DECODE


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def streams(b, s, distinct, start=0, seed=0):
    """``[3, B, S]`` int32 position streams from ``start``: equal (text)
    or three distinct ones (t, h, w of an image's patches)."""
    base = np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s))
    if not distinct:
        return np.stack([base] * 3)
    rng = np.random.default_rng(seed)
    return np.stack([base, base // 2 + rng.integers(0, 3, (b, s)),
                     (base * 3) % 7 + rng.integers(0, 5, (b, s))]
                    ).astype(np.int32)


# --------------------------------------------------------------------- #
# apply_mrope                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("distinct", [True, False])
@pytest.mark.parametrize("hd,sections,theta", [(16, (2, 3, 3), 1e6),
                                              (128, (16, 24, 24), 1e6),
                                              (32, (8, 4, 4), 1e4)])
def test_apply_mrope_matches_reference(hd, sections, theta, distinct):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = streams(2, 9, distinct, start=4, seed=hd)
    want = j_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta,
                                sections)
    got = t_common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta, sections)
    close(got, want)
    rope = t_common.apply_rope(torch.from_numpy(x),
                               torch.from_numpy(pos[0]), theta)
    if distinct:
        assert (got - rope).abs().amax() > 1e-3
    else:
        torch.testing.assert_close(got, rope, rtol=0, atol=0)


def test_apply_mrope_checks_its_sections():
    x = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="sections"):
        t_common.apply_mrope(x, torch.zeros(3, 1, 2, dtype=torch.int32),
                             1e6, (2, 3, 4))


# --------------------------------------------------------------------- #
# reduced qwen2-vl-2b                                                    #
# --------------------------------------------------------------------- #
def with_biases(np_params, seed=0):
    """The reference's numpy pytree with every q/k/v bias overwritten by
    seeded normals (scale 0.5)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {name: walk(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape).astype(v.dtype) * 0.5
                 if name in ("bq", "bk", "bv") else v)
                for name, v in tree.items()}
    return walk(np_params)


@functools.lru_cache(maxsize=None)
def model_pair(arch=ARCH, backend="ref", **kw):
    """(j_cfg, t_cfg, j_params, t_params) of a reduced float32 model, the
    same weights on both sides, non-zero biases."""
    kw = dict(kw)
    j_cfg = j_get_reduced(arch).replace(dtype="float32", **kw)
    t_cfg = get_reduced(arch).replace(dtype="float32", attn_backend=backend,
                                      **kw)
    np_params = with_biases(jax.tree.map(
        np.asarray, jt.init_lm(jax.random.PRNGKey(0), j_cfg)))
    return (j_cfg, t_cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, t_cfg, device="cpu"))


def reference_layers(j_cfg, caches):
    """The reference's per-layer KV caches as a list in layer order."""
    p = j_cfg.layer_period()
    group = caches.get("group", {})
    n_rep = group["pos0"].k.shape[0] if group else 0
    out = [(group[f"pos{pos}"].k[rep], group[f"pos{pos}"].v[rep])
           for rep in range(n_rep) for pos in range(p)]
    i = 0
    while f"rem{i}" in caches:
        out.append(tuple(caches[f"rem{i}"]))
        i += 1
    return out


def check(t_out, j_out, j_cfg):
    close(t_out.logits, j_out.logits)
    ref = reference_layers(j_cfg, j_out.caches)
    for (jk, jv), tcache in zip(ref, t_out.caches, strict=True):
        close(tcache.k, jk)
        close(tcache.v, jv)


def run_both(backend, mode, arch=ARCH, **kw):
    """Prefill ``PROMPT_LEN`` tokens (``mode`` "pos3d": with distinct
    position streams; "embeds": with the embeddings passed in and distinct
    streams; "text": tokens only), then ``N_DECODE`` decode steps (with a
    ``[3, B, 1]`` stream where the prefill had them); every step's logits
    and KV caches must agree.  Returns the last outputs."""
    j_cfg, t_cfg, j_params, t_params = model_pair(arch, backend, **kw)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    steps = rng.integers(0, t_cfg.vocab, (N_DECODE, BATCH, 1)).astype(
        np.int32)
    pos = streams(BATCH, PROMPT_LEN + N_DECODE, mode != "text", seed=3)
    j_kw, t_kw = {}, {}
    if mode != "text":
        j_kw["pos3d"] = jnp.asarray(pos[:, :, :PROMPT_LEN])
        t_kw["pos3d"] = torch.from_numpy(pos[:, :, :PROMPT_LEN].copy())
    if mode == "embeds":
        emb = rng.standard_normal((BATCH, PROMPT_LEN, t_cfg.d_model)).astype(
            np.float32)
        j_kw["embeds"] = jnp.asarray(emb)
        t_kw["embeds"] = torch.from_numpy(emb)
    j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(prompt), mode="prefill",
                        **j_kw)
    t_out = tt.lm_apply(t_params, t_cfg, None if mode == "embeds" else
                        torch.as_tensor(prompt, dtype=torch.long), **t_kw)
    check(t_out, j_out, j_cfg)
    j_eng = JServeEngine(j_build(j_cfg), max_len=MAX_LEN, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=MAX_LEN, batch_size=BATCH,
                         device="cpu")
    j_caches = j_eng._merge(j_eng.init_caches(None), j_out.caches)
    t_caches = t_eng._merge(t_eng.init_caches(None), t_out.caches)
    for i, tok in enumerate(steps):
        j_kw, t_kw = {}, {}
        if mode != "text":
            at = pos[:, :, PROMPT_LEN + i:PROMPT_LEN + i + 1]
            j_kw["pos3d"] = jnp.asarray(at)
            t_kw["pos3d"] = torch.from_numpy(at.copy())
        j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(tok), mode="decode",
                            caches=j_caches,
                            cache_len=jnp.asarray(PROMPT_LEN + i, jnp.int32),
                            **j_kw)
        t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(
            tok, dtype=torch.long), mode="decode", caches=t_caches,
            cache_len=PROMPT_LEN + i, **t_kw)
        check(t_out, j_out, j_cfg)
        j_caches, t_caches = j_out.caches, t_out.caches
    return t_out


@pytest.mark.parametrize("mode", ["pos3d", "embeds", "text"])
@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_prefill_and_decode_match_reference(backend, mode):
    run_both(backend, mode)


def test_pos3d_moves_the_logits():
    """Distinct streams change the logits; three equal ones give the
    text-only logits bitwise."""
    _, t_cfg, _, t_params = model_pair()
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, t_cfg.vocab, (BATCH, PROMPT_LEN)))
    text = tt.lm_apply(t_params, t_cfg, prompt).logits
    equal = tt.lm_apply(t_params, t_cfg, prompt, pos3d=torch.from_numpy(
        streams(BATCH, PROMPT_LEN, False))).logits
    image = tt.lm_apply(t_params, t_cfg, prompt, pos3d=torch.from_numpy(
        streams(BATCH, PROMPT_LEN, True, seed=3))).logits
    torch.testing.assert_close(equal, text, rtol=0, atol=0)
    assert (image - text).abs().amax() > 1e-3


def test_registry_passes_pos3d_on():
    _, t_cfg, _, t_params = model_pair()
    model = t_build(t_cfg)
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, t_cfg.vocab, (BATCH, PROMPT_LEN)))
    pos = torch.from_numpy(streams(BATCH, PROMPT_LEN, True, seed=3))
    logits, _ = model.prefill(t_params, {"tokens": prompt, "pos3d": pos})
    want = tt.lm_apply(t_params, t_cfg, prompt, pos3d=pos).logits
    torch.testing.assert_close(logits, want, rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_generate_matches_reference(backend):
    """Text-only serving, as the reference's engine serves the model (no
    ``pos3d``): greedy tokens equal."""
    j_cfg, t_cfg, j_params, t_params = model_pair(ARCH, backend)
    prompt = np.random.default_rng(11).integers(
        0, t_cfg.vocab, (BATCH, 10)).astype(np.int32)
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=16, batch_size=BATCH,
                         device="cpu")
    j_r = j_eng.generate(j_params, prompt, 6)
    t_r = t_eng.generate(t_params, prompt, 6)
    assert t_r["complete"] and j_r["complete"]
    np.testing.assert_array_equal(t_r["tokens"], np.asarray(j_r["tokens"]))


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
def test_size_equals_reference(which):
    """``param_count`` as the reference's (1,777,088,000 at the full
    config: 3.6 GB in bf16), and at ``reduced()`` the element count of
    both frameworks' ``init_lm``."""
    t = get_config(ARCH) if which == "CONFIG" else get_reduced(ARCH)
    j = j_get_config(ARCH) if which == "CONFIG" else j_get_reduced(ARCH)
    assert t.param_count() == j.param_count()
    assert t.layer_plan() == j.layer_plan()
    if which == "CONFIG":
        assert t.param_count() == 1_777_088_000
        return
    params = tt.init_lm(t, torch.Generator().manual_seed(0), device="cpu")
    n = sum(w.numel() for w in [params["embed"], params["unembed"],
                                params["final_norm"]]
            + [w for layer in params["layers"] for part in layer.values()
               for w in part.values()])
    assert n == t.param_count() == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(
            jt.init_lm(jax.random.PRNGKey(0), j)))


# --------------------------------------------------------------------- #
# tie_embeddings and prefill_last_only                                   #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_tie_embeddings_matches_reference(backend):
    """Reduced qwen2.5-14b tied: no ``unembed`` on either side (the
    count drops it too), logits through ``embed.T``, prefill and decode
    equal to the reference's."""
    j_cfg, t_cfg, _, t_params = model_pair("qwen2.5-14b", backend,
                                           tie_embeddings=True)
    assert "unembed" not in t_params
    assert t_cfg.param_count() == j_cfg.param_count() == \
        get_reduced("qwen2.5-14b").param_count() - t_cfg.vocab * \
        t_cfg.d_model
    own = tt.init_lm(t_cfg, torch.Generator().manual_seed(0), device="cpu")
    assert "unembed" not in own
    run_both(backend, "text", arch="qwen2.5-14b", tie_embeddings=True)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_prefill_last_only_matches_reference(backend):
    """Reduced qwen2.5-14b with ``prefill_last_only``: a prefill returns
    ``[B, 1, V]`` logits (the last position's, equal to the full prefill's
    last row) and the whole prompt's KV caches; decode is unchanged; the
    engine's tokens equal the reference's."""
    j_cfg, t_cfg, j_params, t_params = model_pair(
        "qwen2.5-14b", backend, prefill_last_only=True)
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, t_cfg.vocab, (BATCH, PROMPT_LEN)))
    last = tt.lm_apply(t_params, t_cfg, prompt)
    full = tt.lm_apply(t_params, t_cfg.replace(prefill_last_only=False),
                       prompt)
    assert tuple(last.logits.shape) == (BATCH, 1, t_cfg.vocab)
    torch.testing.assert_close(last.logits, full.logits[:, -1:], rtol=0,
                               atol=0)
    assert last.caches[0].k.shape[1] == PROMPT_LEN
    run_both(backend, "text", arch="qwen2.5-14b", prefill_last_only=True)
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=16, batch_size=BATCH,
                         device="cpu")
    p = prompt[:, :10].numpy().astype(np.int32)
    np.testing.assert_array_equal(
        t_eng.generate(t_params, p, 5)["tokens"],
        np.asarray(j_eng.generate(j_params, p, 5)["tokens"]))
