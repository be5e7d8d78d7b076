"""The port's encoder-decoder (``whisper-tiny``, models/whisper.py) against
the JAX package on the CPU.

Reduced ``whisper-tiny`` in float32 with the reference's weights from its
``init_encdec``, carried over with ``params_from_jax``, on the same
numpy-seeded frames (``[B, 37, d]``: 37 frames, so the reference's
``attn_chunk=32`` has a tail) and tokens: ``encode``, ``cross_kv``,
``decoder_apply`` in prefill and in decode (3 steps at per-row ``[B]``
lengths, the shorter row overwriting its prompt's tail), and
``build_model``'s ``prefill``/``decode_step``, each under both
attention backends (``kernel``: ``flash_attention`` for the encoder, the
decoder's prefill and the prefill's cross-attention, ``decode_attention``
for decode self- and cross-attention, their plain versions on the CPU).
The reference's Whisper reaches no Pallas kernel, so it runs as it is.

Also here: ``param_count`` (reduced, and 61,074,432 for the full config),
``init_caches``' shapes, reduced ``qwen2.5-14b`` with encoder layers (a
``qkv_bias`` config: its self-attention has biases, overwritten with
seeded non-zero values, its cross-attention none; GQA at 8 query heads
over 2), a config with ``tie_embeddings``, ``sliding_window``,
``prefill_last_only`` and experts, which the encoder-decoder ignores on
both sides, the logit softcap (read by self- and cross-attention; the
kernel backend's decode refuses it), the carried bf16 weights equal by
bits, and ``dense_init``'s in-place scaling bitwise equal to the old
formula.

Tolerance: float32 on both sides, products and softmax summed in other
orders; the tests hold outputs to rtol = atol = 1e-5, the other families'
tolerance (``tests/test_torch_dense.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import whisper as jw
from repro.models.attention import KVCache as JKVCache
from repro.models.registry import build_model as j_build
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.models import common as t_common
from repro_torch.models import whisper as tw
from repro_torch.models.attention import KVCache
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving.engine import ServeEngine as TServeEngine

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-5, atol=1e-5)
FRAMES, PROMPT_LEN, N_DECODE, BATCH = 37, 12, 3, 2
MAX_LEN = PROMPT_LEN + N_DECODE
ROWS = np.array([PROMPT_LEN, PROMPT_LEN - 3], dtype=np.int32)
BACKENDS = ["ref", "kernel"]
# switches of the LM that the encoder-decoder reads on neither side
IGNORED = dict(tie_embeddings=True, sliding_window=4, global_every=2,
               prefill_last_only=True, n_experts=4, top_k=2)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def with_biases(np_params, seed=0):
    """The reference's numpy pytree with every q/k/v bias overwritten by
    seeded normals (scale 0.5; the reference initialises them to zero,
    which would hide a missing bias add)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        return {name: walk(v) if isinstance(v, dict) else
                (rng.standard_normal(v.shape).astype(v.dtype) * 0.5
                 if name in ("bq", "bk", "bv") else v)
                for name, v in tree.items()}
    return walk(np_params)


def cfg_pair(arch=ARCH, backend="ref", **kw):
    """(reference cfg, port cfg): ``reduced()`` in float32 with ``kw``,
    the port's with ``attn_backend=backend``."""
    kw = dict(kw)
    return (j_get_reduced(arch).replace(dtype="float32", **kw),
            get_reduced(arch).replace(dtype="float32", attn_backend=backend,
                                      **kw))


@functools.lru_cache(maxsize=None)
def weights(arch=ARCH, **kw):
    """(reference params, the port's params on the CPU) of a reduced
    float32 encoder-decoder, the same weights on both sides."""
    j_cfg, t_cfg = cfg_pair(arch, **kw)
    np_params = with_biases(jax.tree.map(
        np.asarray, j_build(j_cfg).init(jax.random.PRNGKey(0))))
    return (jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, t_cfg, device="cpu"))


def inputs(cfg, seed=0):
    """Seeded frames ``[B, FRAMES, d]`` and tokens ``[B, MAX_LEN]``."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((BATCH, FRAMES, cfg.d_model)).astype(
        np.float32)
    return frames, rng.integers(0, cfg.vocab, (BATCH, MAX_LEN)).astype(
        np.int32)


def reference_run(arch=ARCH, rows=True, **kw):
    """The reference's prefill logits, cross k/v, prefill caches, and the
    logits and caches of ``N_DECODE`` decode steps (at per-row lengths
    ``ROWS + i`` with ``rows``, else at ``PROMPT_LEN + i``)."""
    j_cfg, _ = cfg_pair(arch, **kw)
    jp, _ = weights(arch, **kw)
    frames, toks = inputs(j_cfg)
    h_enc = jw.encode(jp, j_cfg, jnp.asarray(frames))
    ckv = jw.cross_kv(jp, j_cfg, h_enc)
    out = jw.decoder_apply(jp, j_cfg, jnp.asarray(toks[:, :PROMPT_LEN]),
                           ckv, mode="prefill")
    caches = jw.init_decoder_caches(j_cfg, BATCH, MAX_LEN)
    caches = JKVCache(caches.k.at[:, :, :PROMPT_LEN].set(out.caches.k),
                      caches.v.at[:, :, :PROMPT_LEN].set(out.caches.v))
    steps = []
    for i in range(N_DECODE):
        lens = jnp.asarray(ROWS + i) if rows else PROMPT_LEN + i
        tok = jnp.asarray(toks[:, PROMPT_LEN + i:PROMPT_LEN + i + 1])
        dec = jw.encdec_decode(jp, j_cfg, tok, ckv, caches, lens)
        caches = dec.caches
        steps.append((dec.logits, caches))
    return {"h_enc": h_enc, "ckv": ckv, "prefill": out, "steps": steps}


@functools.lru_cache(maxsize=None)
def reference(arch=ARCH, rows=True, items=()):
    return reference_run(arch, rows, **dict(items))


def merged(cfg, prefill_caches):
    """``MAX_LEN``-slot self caches with the prompt's k/v in front."""
    caches = tw.init_decoder_caches(cfg, BATCH, MAX_LEN, device="cpu")
    for buf, new in zip(caches, prefill_caches):
        buf.k[:, :PROMPT_LEN] = new.k
        buf.v[:, :PROMPT_LEN] = new.v
    return caches


def check_caches(got, want_k, want_v):
    """Per-layer port caches against the reference's stacked ones."""
    assert len(got) == want_k.shape[0]
    for i, c in enumerate(got):
        close(c.k, want_k[i])
        close(c.v, want_v[i])


# --------------------------------------------------------------------- #
# the modules, step by step                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", BACKENDS)
def test_encode_matches_reference(backend):
    _, t_cfg = cfg_pair(backend=backend)
    _, tp = weights()
    frames, _ = inputs(t_cfg)
    close(tw.encode(tp, t_cfg, torch.from_numpy(frames)),
          reference()["h_enc"])


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_kv_matches_reference(backend):
    _, t_cfg = cfg_pair(backend=backend)
    _, tp = weights()
    frames, _ = inputs(t_cfg)
    ckv = tw.cross_kv(tp, t_cfg, tw.encode(tp, t_cfg,
                                           torch.from_numpy(frames)))
    want_k, want_v = reference()["ckv"]
    assert ckv[0].k.shape == (BATCH, FRAMES, t_cfg.n_kv_heads,
                              t_cfg.head_dim)
    check_caches(ckv, want_k, want_v)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decoder_prefill_and_decode_at_per_row_lengths(backend):
    """``decoder_apply`` over the reference's own cross k/v: prefill
    logits and caches, then 3 decode steps at ``[B]`` lengths (row 1 three
    positions behind row 0), logits and every layer's cache."""
    _, t_cfg = cfg_pair(backend=backend)
    _, tp = weights()
    _, toks = inputs(t_cfg)
    ref = reference()
    ckv = [KVCache(torch.from_numpy(np.array(k)),
                   torch.from_numpy(np.array(v)))
           for k, v in zip(*ref["ckv"])]
    out = tw.decoder_apply(tp, t_cfg, torch.from_numpy(toks[:, :PROMPT_LEN])
                           .long(), ckv, mode="prefill")
    close(out.logits, ref["prefill"].logits)
    check_caches(out.caches, ref["prefill"].caches.k,
                 ref["prefill"].caches.v)
    caches = merged(t_cfg, out.caches)
    for i, (want_logits, want_c) in enumerate(ref["steps"]):
        tok = torch.from_numpy(toks[:, PROMPT_LEN + i:][:, :1]).long()
        out = tw.encdec_decode(tp, t_cfg, tok, ckv, caches,
                               torch.from_numpy(ROWS + i))
        caches = out.caches
        close(out.logits, want_logits)
        check_caches(caches, want_c.k, want_c.v)


@pytest.mark.parametrize("rows", [True, False], ids=["rows", "scalar"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_build_model_prefill_and_decode_step(backend, rows):
    """The model API end to end: ``prefill`` (frames and prompt) returns
    ``{"self", "cross"}``; ``decode_step`` carries ``"cross"`` through
    unchanged, at per-row ``[B]`` lengths or one int."""
    _, t_cfg = cfg_pair(backend=backend)
    _, tp = weights()
    frames, toks = inputs(t_cfg)
    ref = reference(rows=rows)
    model = t_build(t_cfg)
    logits, caches = model.prefill(tp, {
        "frames": torch.from_numpy(frames),
        "tokens": torch.from_numpy(toks[:, :PROMPT_LEN]).long()})
    close(logits, ref["prefill"].logits)
    check_caches(caches["cross"], *ref["ckv"])
    cross = caches["cross"]
    caches = {"self": merged(t_cfg, caches["self"]), "cross": cross}
    for i, (want_logits, want_c) in enumerate(ref["steps"]):
        lens = torch.from_numpy(ROWS + i) if rows else PROMPT_LEN + i
        logits, caches = model.decode_step(tp, {
            "tokens": torch.from_numpy(toks[:, PROMPT_LEN + i:][:, :1])
            .long(), "cache_len": lens}, caches)
        assert caches["cross"] is cross
        close(logits, want_logits)
        check_caches(caches["self"], want_c.k, want_c.v)


# --------------------------------------------------------------------- #
# configs, sizes and caches                                              #
# --------------------------------------------------------------------- #
def leaves(params):
    out = []
    for v in params.values():
        if isinstance(v, dict):
            out += leaves(v)
        elif isinstance(v, list):
            for layer in v:
                out += leaves(layer)
        else:
            out.append(v)
    return out


def test_param_count_equals_reference_and_init():
    assert get_config(ARCH).param_count() == 61_074_432 == \
        j_get_config(ARCH).param_count()
    cfg = get_reduced(ARCH)
    assert cfg.param_count() == j_get_reduced(ARCH).param_count()
    params = tw.init_encdec(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    j_params = j_build(j_get_reduced(ARCH)).init(jax.random.PRNGKey(0))
    assert sum(p.numel() for p in leaves(params)) == cfg.param_count() \
        == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(j_params))


def test_init_matches_reference_layout():
    """Names, shapes and dtypes of every parameter as the reference's
    (layer ``i`` of its stacks), bf16 as the config asks; ``wo`` scaled
    by the decoder's depth in the encoder too; cross blocks bias-free."""
    cfg = get_reduced(ARCH).replace(qkv_bias=True)
    tp = tw.init_encdec(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = j_build(j_get_reduced(ARCH).replace(qkv_bias=True)).init(
        jax.random.PRNGKey(0))
    for part in ("encoder", "decoder"):
        for i, layer in enumerate(tp[part]):
            for block, names in layer.items():
                want = jp[part][block]
                assert sorted(names) == sorted(want), (part, block)
                for n, w in names.items():
                    assert tuple(w.shape) == want[n].shape[1:]
                    assert w.dtype == torch.bfloat16
    assert "bq" in tp["decoder"][0]["self"] and \
        "bq" not in tp["decoder"][0]["cross"]
    wo = tp["encoder"][0]["attn"]["wo"].float()
    std = (cfg.n_heads * cfg.head_dim) ** -0.5 / (2 * cfg.n_layers) ** 0.5
    assert float(wo.abs().max()) <= 3 * std * (1 + 2 ** -7)
    assert float(wo.std()) > 0.5 * std


def test_init_caches_shapes():
    cfg = get_reduced(ARCH)
    caches = t_build(cfg).init_caches(3, 20, device="cpu")
    want = j_build(j_get_reduced(ARCH)).init_caches(3, 20)
    assert len(caches["self"]) == len(caches["cross"]) == cfg.n_layers
    for part, (wk, wv) in (("self", want["self"]), ("cross", want["cross"])):
        for c in caches[part]:
            assert tuple(c.k.shape) == wk.shape[1:] == tuple(c.v.shape) \
                == wv.shape[1:]
            assert c.k.dtype == torch.bfloat16 and not c.k.any()


def test_engine_refuses_an_encoder_decoder():
    with pytest.raises(ValueError, match="decoder-only"):
        TServeEngine(t_build(get_reduced(ARCH)), max_len=8, batch_size=2,
                     device="cpu")


# --------------------------------------------------------------------- #
# what the encoder-decoder reads and ignores                             #
# --------------------------------------------------------------------- #
def full_run(t_cfg, tp, rows=True):
    """The port's prefill logits and the logits of ``N_DECODE`` steps
    through ``build_model``."""
    frames, toks = inputs(t_cfg)
    model = t_build(t_cfg)
    logits, caches = model.prefill(tp, {
        "frames": torch.from_numpy(frames),
        "tokens": torch.from_numpy(toks[:, :PROMPT_LEN]).long()})
    out = [logits]
    caches["self"] = merged(t_cfg, caches["self"])
    for i in range(N_DECODE):
        lens = torch.from_numpy(ROWS + i) if rows else PROMPT_LEN + i
        logits, caches = model.decode_step(tp, {
            "tokens": torch.from_numpy(toks[:, PROMPT_LEN + i:][:, :1])
            .long(), "cache_len": lens}, caches)
        out.append(logits)
    return out


def check_run(got, ref):
    close(got[0], ref["prefill"].logits)
    for g, (w, _) in zip(got[1:], ref["steps"]):
        close(g, w)


@pytest.mark.parametrize("backend", BACKENDS)
def test_qwen_with_encoder_layers(backend):
    """``get_reduced("qwen2.5-14b").replace(encoder_layers=2)`` is an
    encoder-decoder with dense SwiGLU FFNs, biased self-attention (the
    encoder's too; the seeded biases are non-zero) and bias-free
    cross-attention, GQA at 8 query heads over 2, on both sides."""
    kw = dict(encoder_layers=2)
    _, t_cfg = cfg_pair("qwen2.5-14b", backend, **kw)
    jp, tp = weights("qwen2.5-14b", **kw)
    assert "bq" in tp["encoder"][0]["attn"] and "bq" in \
        tp["decoder"][0]["self"] and "bq" not in tp["decoder"][0]["cross"]
    assert set(jp["decoder"]["cross"]) == set(tp["decoder"][0]["cross"])
    assert t_cfg.param_count() == j_get_reduced("qwen2.5-14b").replace(
        **kw).param_count()
    check_run(full_run(t_cfg, tp),
              reference("qwen2.5-14b", items=tuple(kw.items())))


@pytest.mark.parametrize("backend", BACKENDS)
def test_ignored_switches(backend):
    """``tie_embeddings``, ``sliding_window`` (with ``global_every``),
    ``prefill_last_only`` and experts change nothing in an
    encoder-decoder, on either side: the same parameters (an ``unembed``,
    dense FFNs) and, on the same weights, the plain config's logits at
    every position."""
    _, t_cfg = cfg_pair(backend=backend, **IGNORED)
    jp, tp = weights(**IGNORED)
    plain_j, plain_t = weights()
    assert sorted(tp) == sorted(plain_t) and "unembed" in tp
    assert sorted(tp["decoder"][0]["ffn"]) == ["norm", "w_down", "w_gate",
                                              "w_up"]
    assert jax.tree.structure(jp) == jax.tree.structure(plain_j)
    got = full_run(t_cfg, plain_t)
    assert got[0].shape == (BATCH, PROMPT_LEN, t_cfg.vocab)
    check_run(got, reference(items=tuple(IGNORED.items())))
    check_run(got, reference())


@pytest.mark.parametrize("backend", BACKENDS)
def test_softcap_in_self_and_cross_attention(backend):
    """``attn_logit_softcap`` is read by self- and cross-attention: the
    ``ref`` backend matches the reference with it; the ``kernel``
    backend's prefill (``flash_attention`` has a softcap) matches, and its
    decode, which ``decode_attention`` cannot softcap, raises."""
    kw = dict(attn_logit_softcap=0.5)
    _, t_cfg = cfg_pair(backend=backend, **kw)
    _, tp = weights()
    ref = reference(rows=False, items=tuple(kw.items()))
    plain = reference(rows=False)
    assert float(jnp.abs(ref["prefill"].logits
                         - plain["prefill"].logits).max()) > 1e-3
    if backend == "ref":
        check_run(full_run(t_cfg, tp, rows=False), ref)
        return
    frames, toks = inputs(t_cfg)
    model = t_build(t_cfg)
    logits, caches = model.prefill(tp, {
        "frames": torch.from_numpy(frames),
        "tokens": torch.from_numpy(toks[:, :PROMPT_LEN]).long()})
    close(logits, ref["prefill"].logits)
    caches["self"] = merged(t_cfg, caches["self"])
    with pytest.raises(ValueError, match="softcap"):
        model.decode_step(tp, {"tokens": torch.from_numpy(
            toks[:, PROMPT_LEN:][:, :1]).long(), "cache_len": PROMPT_LEN},
            caches)


def test_norm_kind_is_read_by_no_module():
    """``norm_kind="layernorm"`` builds and computes what ``"rmsnorm"``
    does, on both sides (neither reads it)."""
    _, t_cfg = cfg_pair(norm_kind="layernorm")
    _, tp = weights()
    check_run(full_run(t_cfg, tp), reference())


# --------------------------------------------------------------------- #
# conversion and init                                                    #
# --------------------------------------------------------------------- #
def test_carried_bf16_weights_equal_by_bits():
    """Every leaf of a bf16 reference pytree, carried by
    ``params_from_jax``, equals the reference's by its bits, layer ``i``
    of each stack at ``encoder[i]`` / ``decoder[i]``."""
    j_cfg = j_get_reduced(ARCH)
    np_params = jax.tree.map(np.asarray,
                             j_build(j_cfg).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(np_params, get_reduced(ARCH), device="cpu")

    def bits(a):
        return np.asarray(a).view(np.int16)

    for name in ("embed", "unembed", "final_norm", "enc_final_norm"):
        assert tp[name].dtype == torch.bfloat16
        assert np.array_equal(tp[name].view(torch.int16).numpy(),
                              bits(np_params[name]))
    for part in ("encoder", "decoder"):
        for i, layer in enumerate(tp[part]):
            for block, names in layer.items():
                for n, w in names.items():
                    assert np.array_equal(
                        w.view(torch.int16).numpy(),
                        bits(np_params[part][block][n][i])), (part, i, n)


def test_convert_checks_the_layer_counts():
    np_params = jax.tree.map(np.asarray, j_build(j_get_reduced(ARCH)).init(
        jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="found 2 encoder layers"):
        params_from_jax(np_params, get_reduced(ARCH).replace(
            encoder_layers=3), device="cpu")


@pytest.mark.parametrize("shape,scale", [((64, 96), None), ((3, 40, 24), 0.1),
                                         ((17,), None), ((96, 64), 0.03125)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dense_init_scales_in_place_bitwise(shape, scale, dtype):
    """``dense_init`` scales its float32 draw in place; the values are
    bitwise those of the out-of-place formula it replaced."""
    got = t_common.dense_init(shape, dtype, torch.Generator().manual_seed(5),
                              torch.device("cpu"), scale=scale)
    w = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0,
                                generator=torch.Generator().manual_seed(5))
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    want = (w * (scale if scale is not None else fan_in ** -0.5)).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
