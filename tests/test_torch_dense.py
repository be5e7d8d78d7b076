"""The port's dense LMs without nesting against the JAX package on the CPU:
``stablelm-12b``, ``qwen2.5-14b``, ``qwen2.5-32b`` and ``gemma3-1b``.

Each model runs at its ``reduced()`` config in float32 with weights from
the reference's ``init_lm``, carried over with ``params_from_jax``.  The
reference initialises the q/k/v biases to zero, which would hide a
missing bias add, so the fixtures overwrite them with seeded non-zero
values first.  Prompts are 16 tokens: longer than gemma3's reduced window
of 8, so the window masks in prefill and in every decode step.

Tolerance: float32 in both frameworks, but matrix products and softmax
reduce in different orders, so logits agree to about 2e-6; the tests hold
them to rtol = atol = 1e-5, as ``tests/test_torch_model.py`` does.  The
port runs with each ``attn_backend``: ``ref`` and ``kernel``, whose
wrappers run ``flash_attention`` / ``decode_attention``'s plain versions
on the CPU.  The reference's non-nested attention reads no backend field.
The kernels take head dims that are multiples of 8, and stablelm's
``reduced()`` has 20, so its kernel-backend cases run at head_dim 24 on
both sides (the full config's 160 is a multiple of 8).

Also here: the per-row ``[B]`` ``cache_len`` of decode (``_scatter_at``
and ``_sdpa_decode``, through ``attention`` and ``nested_attention``),
config fields and ``param_count``, ``build_model`` by family (MoE, hybrid
and vlm included; their own tests are in ``tests/test_torch_moe.py``,
``test_torch_hybrid.py`` and ``test_torch_vlm.py``), the refusals of what
is not ported and the fields that once were refused, the period-6
unstacking of gemma3's layers, the engine's caches,
``ServeEngine.generate`` and two ticks of the fleet server against the
reference's.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_IDS as J_ALL_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import controller as jc
from repro.models import attention as j_attn
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.serving import alert_server as js
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import ALL_IDS, get_config, get_reduced
from repro_torch.configs import alert_anytime as t_anytime
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import controller as tc
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import alert_server as ts
from repro_torch.serving.engine import ServeEngine as TServeEngine

ARCHS = ["stablelm-12b", "qwen2.5-14b", "qwen2.5-32b", "gemma3-1b"]
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT_LEN, N_DECODE, BATCH = 16, 4, 2
MAX_LEN = PROMPT_LEN + N_DECODE


def reduced_pair(arch, backend="ref", **kw):
    """(reference cfg, port cfg): ``reduced()`` in float32, the port's
    with ``attn_backend=backend``; stablelm's at head_dim 24 on the kernel
    backend (see the module docstring)."""
    if backend == "kernel" and arch == "stablelm-12b":
        kw = dict(kw, head_dim=24)
    j_cfg = j_get_reduced(arch).replace(dtype="float32", **kw)
    t_cfg = get_reduced(arch).replace(dtype="float32", attn_backend=backend,
                                      **kw)
    return j_cfg, t_cfg


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
def model_pair(arch, backend="ref", banded=False):
    """(j_cfg, t_cfg, j_params, t_params) of a reduced float32 model, the
    same weights on both sides, non-zero biases where the config has
    them."""
    kw = dict(window_banded=True, attn_chunk=4) if banded else {}
    j_cfg, t_cfg = reduced_pair(arch, backend, **kw)
    np_params = with_biases(jax.tree.map(
        np.asarray, jt.init_lm(jax.random.PRNGKey(0), j_cfg)))
    j_params = jax.tree.map(jnp.asarray, np_params)
    t_params = params_from_jax(np_params, t_cfg, device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def reference_layers(j_cfg, caches):
    """The reference's per-layer caches (stacked per period position,
    then the remainder) as a list in layer order."""
    p = j_cfg.layer_period()
    out = []
    group = caches.get("group", {})
    n_rep = group["pos0"].k.shape[0] if group else 0
    for rep in range(n_rep):
        for pos in range(p):
            c = group[f"pos{pos}"]
            out.append((c.k[rep], c.v[rep]))
    i = 0
    while f"rem{i}" in caches:
        out.append(tuple(caches[f"rem{i}"]))
        i += 1
    return out


def check_caches(j_cfg, t_caches, j_caches):
    ref = reference_layers(j_cfg, j_caches)
    assert len(ref) == len(t_caches) == j_cfg.n_layers
    for (jk, jv), tcache in zip(ref, t_caches):
        close(tcache.k, jk)
        close(tcache.v, jv)


# --------------------------------------------------------------------- #
# configs                                                                #
# --------------------------------------------------------------------- #
FIELDS = [f.name for f in dataclasses.fields(ModelConfig)]


@pytest.mark.parametrize("which", ["CONFIG", "reduced"])
@pytest.mark.parametrize("arch", ALL_IDS)
def test_config_fields_equal_reference(arch, which):
    j = j_get_config(arch) if which == "CONFIG" else j_get_reduced(arch)
    t = get_config(arch) if which == "CONFIG" else get_reduced(arch)
    for name in FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    assert t.layer_plan() == j.layer_plan()
    assert t.layer_period() == j.layer_period()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_reference_and_init(arch):
    """``param_count()`` as the reference's, at the full config (the
    published sizes) and at ``reduced()``, where it equals the element
    count of the port's own ``init_lm`` and of the reference's."""
    assert get_config(arch).param_count() == j_get_config(arch).param_count()
    t_cfg = get_reduced(arch)
    assert t_cfg.param_count() == j_get_reduced(arch).param_count()
    params = tt.init_lm(t_cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    n = sum(p.numel() for p in [params["embed"], params["unembed"],
                                params["final_norm"]]
            + [w for layer in params["layers"] for part in layer.values()
               for w in part.values()])
    j_params = jt.init_lm(jax.random.PRNGKey(0), j_get_reduced(arch))
    assert n == t_cfg.param_count() == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(j_params))


def test_published_sizes():
    want = {"qwen2.5-14b": 14_770_033_664, "stablelm-12b": 12_142_924_800,
            "gemma3-1b": 1_301_802_624, "qwen2.5-32b": 32_763_876_352}
    assert {a: get_config(a).param_count() for a in want} == want


def test_gemma3_layer_plan():
    cfg = get_config("gemma3-1b")
    glob = [i for i in range(cfg.n_layers) if cfg.mixer_kind(i) == "attn"]
    assert glob == [5, 11, 17, 23]
    assert all(cfg.mixer_kind(i) == "attn_local"
               for i in range(cfg.n_layers) if i not in glob)
    assert cfg.layer_period() == 6 and cfg.sliding_window == 512


@pytest.mark.parametrize("field,value,item", [
    ("family", "encdec", "A3.5"), ("encoder_layers", 4, "A3.5"),
    ("norm_kind", "layernorm", "A3.5")])
def test_config_refuses_unported(field, value, item):
    """The fields the port refused until ROADMAP A3.5 (``item``) ported
    the encoder-decoder now build and equal the reference: the layer plan
    and ``param_count``, and the model ``build_model`` makes of them.
    ``family="encdec"`` without encoder layers and ``norm_kind=
    "layernorm"`` (which no module reads, on either side) give the plain
    decoder-only LM, with the same logits; ``encoder_layers=4`` an
    encoder-decoder with 4 encoder layers (``build_model`` dispatches on
    ``encoder_layers``, not on the family)."""
    base = get_reduced("qwen2.5-14b").replace(dtype="float32")
    t = base.replace(**{field: value})
    j = j_get_reduced("qwen2.5-14b").replace(dtype="float32",
                                             **{field: value})
    assert getattr(t, field) == value
    assert t.layer_plan() == j.layer_plan()
    assert t.param_count() == j.param_count()
    model = t_build(t)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    if field == "encoder_layers":
        assert len(params["encoder"]) == value == j.encoder_layers
        assert len(params["decoder"]) == t.n_layers
        return
    assert "encoder" not in params and len(params["layers"]) == t.n_layers
    toks = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, t.vocab, (2, 6)))}
    torch.testing.assert_close(model.prefill(params, toks)[0],
                               t_build(base).prefill(params, toks)[0],
                               rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [
    ("family", "hybrid"), ("attn_every", 8), ("m_rope", True),
    ("tie_embeddings", True), ("prefill_last_only", True)])
def test_config_accepts_ported(field, value):
    """What the port once refused (the hybrid family, Mamba layers,
    M-RoPE, tied embeddings, last-position prefill) now builds, with the
    reference's layer plan and parameter count."""
    t = get_reduced("qwen2.5-14b").replace(**{field: value})
    j = j_get_reduced("qwen2.5-14b").replace(**{field: value})
    assert getattr(t, field) == value
    assert t.layer_plan() == j.layer_plan()
    assert t.param_count() == j.param_count()
    assert t_build(t).cfg is t


def test_get_config_refuses_unported_archs():
    """Every arch of the reference's zoo is ported, whisper-tiny last (at
    the reference's 61,074,432 parameters); an unknown arch is refused."""
    assert set(ALL_IDS) == set(J_ALL_IDS)
    whisper = get_config("whisper-tiny")
    assert whisper.encoder_layers == 4
    assert whisper.param_count() == 61_074_432 == \
        j_get_config("whisper-tiny").param_count()
    with pytest.raises(KeyError, match="unknown"):
        get_reduced("no-such-model")


def test_build_model_by_family():
    model = t_build(get_reduced("gemma3-1b"))
    assert model.cfg.family == "dense"
    model = t_build(get_reduced("olmoe-1b-7b"))     # MoE is ported
    assert model.cfg.family == "moe"
    assert {model.cfg.ffn_kind(i) for i in range(2)} == {"moe"}
    plain = t_build(get_reduced("qwen2.5-14b").replace(family="moe"))
    assert plain.cfg.layer_plan() == get_reduced("qwen2.5-14b").layer_plan()
    hybrid = t_build(get_reduced("jamba-v0.1-52b"))  # and the hybrid, vlm
    assert {m for m, _ in hybrid.cfg.layer_plan()} == {"mamba", "attn"}
    assert t_build(get_reduced("qwen2-vl-2b")).cfg.m_rope
    lm = t_build(get_reduced("qwen2.5-14b").replace(family="encdec"))
    assert lm.cfg.layer_plan() == get_reduced("qwen2.5-14b").layer_plan()
    assert "layers" in lm.init(device="cpu")   # no encoder: the LM
    encdec = t_build(get_reduced("whisper-tiny"))
    assert len(encdec.init(device="cpu")["encoder"]) == 2
    with pytest.raises(ValueError, match="unknown family"):
        get_reduced("qwen2.5-14b").replace(family="cnn")


# --------------------------------------------------------------------- #
# conversion and init                                                    #
# --------------------------------------------------------------------- #
def test_convert_unstacks_period_six_with_remainder():
    """gemma3-1b's full plan: ``group.pos0..pos5`` x 4 repeats, then
    ``rem0``, ``rem1``.  Every leaf of a stand-in pytree carries its
    layer's index; layer ``rep*6 + pos`` must land at ``layers[rep*6 +
    pos]``, the remainders at 24 and 25."""
    cfg = get_config("gemma3-1b")
    p, n = cfg.layer_period(), cfg.n_layers
    r = n // p

    def leaves(idx):
        return {"mixer": {"wq": np.asarray(idx, np.float32).reshape(
                    np.shape(idx) + (1,)),
                          "bq": np.asarray(idx, np.float32)},
                "ffn": {"w_up": np.asarray(idx, np.float32)}}

    tree = {"embed": np.zeros((2, 2), np.float32),
            "unembed": np.zeros((2, 2), np.float32),
            "final_norm": np.zeros(2, np.float32),
            "group": {f"pos{pos}": leaves(np.arange(r) * p + pos)
                      for pos in range(p)}}
    for i in range(n - r * p):
        tree[f"rem{i}"] = leaves(np.float32(r * p + i))
    layers = params_from_jax(tree, cfg, device="cpu")["layers"]
    assert len(layers) == n
    for i, layer in enumerate(layers):
        assert float(layer["mixer"]["bq"]) == i
        assert float(layer["mixer"]["wq"].reshape(())) == i
        assert float(layer["ffn"]["w_up"]) == i


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-1b"])
def test_converted_layers_and_biases(arch):
    j_cfg, t_cfg, j_params, t_params = model_pair(arch)
    ref = []
    group = j_params.get("group", {})
    for rep in range(t_cfg.n_layers // j_cfg.layer_period()):
        for pos in range(j_cfg.layer_period()):
            ref.append(jax.tree.map(lambda a: a[rep], group[f"pos{pos}"]))
    i = 0
    while f"rem{i}" in j_params:
        ref.append(j_params[f"rem{i}"])
        i += 1
    for layer, want in zip(t_params["layers"], ref, strict=True):
        for part in ("mixer", "ffn"):
            assert sorted(layer[part]) == sorted(want[part])
            for name, w in layer[part].items():
                np.testing.assert_array_equal(w.numpy(),
                                              np.asarray(want[part][name]))
    biases = [layer["mixer"].get("bq") for layer in t_params["layers"]]
    if t_cfg.qkv_bias:
        assert all(b is not None and b.abs().min() > 0 for b in biases)
    else:
        assert all(b is None for b in biases)


def test_port_init_biases_are_zero_and_shaped():
    cfg = get_reduced("qwen2.5-14b")
    layer = tt.init_lm(cfg, torch.Generator().manual_seed(0),
                       device="cpu")["layers"][0]["mixer"]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    assert {n: tuple(layer[n].shape) for n in ("bq", "bk", "bv")} == \
        {"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)}
    assert all(not layer[n].any() for n in ("bq", "bk", "bv"))


# --------------------------------------------------------------------- #
# the model                                                              #
# --------------------------------------------------------------------- #
def prefill_then_decode(arch, backend, banded=False, per_row=None):
    """Prefill ``PROMPT_LEN`` tokens, then ``N_DECODE`` decode steps, on
    both sides; every step's logits and every layer's cache must agree.
    ``per_row``: the first step's ``cache_len`` as one length per row (the
    prompt's k/v stay in the cache past each row's length)."""
    j_cfg, t_cfg, j_params, t_params = model_pair(arch, backend, banded)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    steps = rng.integers(0, t_cfg.vocab, (N_DECODE, BATCH, 1)).astype(
        np.int32)
    j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(prompt), mode="prefill")
    t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(prompt,
                                                         dtype=torch.long))
    close(t_out.logits, j_out.logits)
    check_caches(j_cfg, t_out.caches, j_out.caches)
    j_eng = JServeEngine(j_build(j_cfg), max_len=MAX_LEN, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=MAX_LEN, batch_size=BATCH,
                         device="cpu")
    j_caches = j_eng._merge(j_eng.init_caches(None), j_out.caches)
    t_caches = t_eng._merge(t_eng.init_caches(None), t_out.caches)
    for i, tok in enumerate(steps):
        if per_row is not None and i == 0:
            j_len = jnp.asarray(per_row, jnp.int32)
            t_len = torch.tensor(per_row, dtype=torch.int32)
        else:
            j_len = jnp.asarray(PROMPT_LEN + i, jnp.int32)
            t_len = PROMPT_LEN + i
        j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(tok), mode="decode",
                            caches=j_caches, cache_len=j_len)
        t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(
            tok, dtype=torch.long), mode="decode", caches=t_caches,
            cache_len=t_len)
        close(t_out.logits, j_out.logits)
        check_caches(j_cfg, t_out.caches, j_out.caches)
        j_caches, t_caches = j_out.caches, t_out.caches
        if per_row is not None:
            break


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, backend):
    prefill_then_decode(arch, backend)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_gemma3_window_banded(backend):
    """``window_banded=True`` on both sides at ``attn_chunk`` 4: each
    query chunk of the reference reads a 12-key band of the 16-token
    prompt (the port's ``ref`` backend too; the kernel backend reads the
    window's tiles whatever the flag)."""
    prefill_then_decode("gemma3-1b", backend, banded=True)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-1b"])
def test_decode_with_per_row_cache_len(arch, backend):
    """Step 0 at lengths ``[PROMPT_LEN - 5, PROMPT_LEN]``: row 0 overwrites
    a prompt slot and attends over 11 positions (gemma3: its window's
    last 8), row 1 over all 16."""
    prefill_then_decode(arch, backend, per_row=[PROMPT_LEN - 5, PROMPT_LEN])


def test_window_bites():
    """gemma3's reduced window changes the logits: the same weights with
    the window off give other logits from the 9th prompt token on."""
    j_cfg, t_cfg, _, t_params = model_pair("gemma3-1b")
    prompt = torch.as_tensor(np.random.default_rng(7).integers(
        0, t_cfg.vocab, (BATCH, PROMPT_LEN)))
    windowed = tt.lm_apply(t_params, t_cfg, prompt).logits
    full = tt.lm_apply(t_params, t_cfg.replace(sliding_window=None),
                       prompt).logits
    w = t_cfg.sliding_window
    torch.testing.assert_close(windowed[:, :w], full[:, :w], rtol=0, atol=0)
    assert (windowed[:, w:] - full[:, w:]).abs().amax() > 1e-3


# --------------------------------------------------------------------- #
# per-row cache_len in the attention blocks                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("s_max", [BATCH * 2, 7])
def test_scatter_at_per_row(s_max):
    """Each row written at its own index, as the reference's vmapped
    ``dynamic_update_slice``; ``S_max == B`` (4 rows) included."""
    rng = np.random.default_rng(s_max)
    b = BATCH * 2
    buf = rng.standard_normal((b, s_max, 2, 8)).astype(np.float32)
    upd = rng.standard_normal((b, 1, 2, 8)).astype(np.float32)
    idx = np.array([0, s_max - 1, 2, 1], np.int32)
    want = j_attn._scatter_at(jnp.asarray(buf), jnp.asarray(upd),
                              jnp.asarray(idx))
    got = t_attn._scatter_at(torch.from_numpy(buf.copy()),
                             torch.from_numpy(upd), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("s_max", [BATCH * 2, 9])
def test_sdpa_decode_per_row(s_max, window):
    """Each row masked by its own length (and window); ``S_max == B``
    included, where a mask built over positions could pass for one built
    over rows."""
    rng = np.random.default_rng(s_max)
    b = BATCH * 2
    q = rng.standard_normal((b, 1, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((b, s_max, 2, 8)).astype(np.float32)
            for _ in range(2))
    lens = np.array([1, s_max, 3, 2], np.int32)
    want = j_attn._sdpa_decode(*map(jnp.asarray, (q, k, v, lens)),
                               window=window, softcap=None)
    got = t_attn._sdpa_decode(*map(torch.from_numpy, (q, k, v, lens)),
                              window=window)
    close(got, want)
    for row in range(b):        # each row as if decoded alone
        alone = t_attn._sdpa_decode(*(torch.from_numpy(a[row:row + 1])
                                      for a in (q, k, v)), int(lens[row]),
                                    window=window)
        torch.testing.assert_close(got[row:row + 1], alone, rtol=0, atol=0)


def attention_layer(block, backend):
    """(j fn, t fn, j params, t params, cfgs) of layer 0 of a reduced
    float32 model: ``attention`` of qwen2.5-14b (biases) or
    ``nested_attention`` of the anytime LM at its deepest level."""
    if block == "attention":
        j_cfg, t_cfg, j_params, t_params = model_pair("qwen2.5-14b",
                                                      backend)
        return (j_attn.attention, t_attn.attention, j_cfg, t_cfg,
                jax.tree.map(lambda a: a[0], j_params["group"]["pos0"]
                             ["mixer"]), t_params["layers"][0]["mixer"], {})
    from repro.configs import alert_anytime as j_anytime
    j_cfg = j_anytime.reduced().replace(dtype="float32")
    t_cfg = t_anytime.reduced().replace(dtype="float32",
                                        attn_backend=backend)
    j_params = jt.init_lm(jax.random.PRNGKey(0), j_cfg)
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    return (j_attn.nested_attention, t_attn.nested_attention, j_cfg, t_cfg,
            jax.tree.map(lambda a: a[0], j_params["group"]["pos0"]["mixer"]),
            t_params["layers"][0]["mixer"], {"level": t_cfg.nest_levels})


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("s_max", [BATCH * 2, 9])
@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("block", ["attention", "nested_attention"])
def test_attention_blocks_decode_per_row(block, backend, s_max, window):
    """One decode step of a whole attention block at lengths that differ
    per row (``S_max == B`` included): output and both cache buffers
    equal the reference's."""
    j_fn, t_fn, j_cfg, t_cfg, j_p, t_p, kw = attention_layer(block, backend)
    rng = np.random.default_rng(s_max + (window or 0))
    b, n_kv, hd = BATCH * 2, t_cfg.n_kv_heads, t_cfg.head_dim
    x = rng.standard_normal((b, 1, t_cfg.d_model)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s_max, n_kv, hd)).astype(np.float32)
              for _ in range(2))
    lens = np.array([0, s_max - 1, 2, 1], np.int32)
    j_out, j_cache = j_fn(j_p, jnp.asarray(x), jnp.asarray(lens[:, None]),
                          j_cfg, window=window,
                          cache=j_attn.KVCache(jnp.asarray(kc),
                                               jnp.asarray(vc)),
                          cache_len=jnp.asarray(lens), **kw)
    t_out, t_cache = t_fn(t_p, torch.from_numpy(x),
                          torch.from_numpy(lens[:, None]), t_cfg,
                          window=window,
                          cache=t_attn.KVCache(torch.from_numpy(kc.copy()),
                                               torch.from_numpy(vc.copy())),
                          cache_len=torch.from_numpy(lens), **kw)
    close(t_out, j_out)
    close(t_cache.k, j_cache.k)
    close(t_cache.v, j_cache.v)


# --------------------------------------------------------------------- #
# serving                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_caches_are_full_width(arch):
    """Without nesting the engine has one level (None) whose caches are
    ``[B, max_len, n_kv_heads, head_dim]`` in every layer."""
    cfg = get_reduced(arch)
    eng = TServeEngine(t_build(cfg), max_len=MAX_LEN, batch_size=3,
                       device="cpu")
    assert eng.levels == [None]
    caches = eng.init_caches(None)
    assert len(caches) == cfg.n_layers
    for c in caches:
        for buf in c:
            assert tuple(buf.shape) == (3, MAX_LEN, cfg.n_kv_heads,
                                        cfg.head_dim)
            assert buf.dtype == torch.bfloat16 and not buf.any()


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-1b"])
def test_generate_matches_reference(arch, backend):
    """Greedy tokens of ``ServeEngine.generate`` equal the reference
    engine's; gemma3's 10-token prompt and 6 new tokens run past its
    window."""
    j_cfg, t_cfg, j_params, t_params = model_pair(arch, backend)
    prompt = np.random.default_rng(11).integers(
        0, t_cfg.vocab, (BATCH, 10)).astype(np.int32)
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=16, batch_size=BATCH,
                         device="cpu")
    j_r = j_eng.generate(j_params, prompt, 6)
    t_r = t_eng.generate(t_params, prompt, 6)
    assert t_r["level"] is None and j_r["level"] is None
    assert t_r["complete"] and j_r["complete"]
    np.testing.assert_array_equal(t_r["tokens"], np.asarray(j_r["tokens"]))


class SteppingClock:
    """Returns 0, 0.01, 0.02, ... on successive calls."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return (self.n - 1) * 0.01


def test_fleet_server_two_ticks_match_reference():
    """The fleet server over reduced gemma3 (one candidate, power adapts
    only), profiled with fake clocks on both sides, then two ticks of
    Eq. 4 and Eq. 5 tenants: every served input equal (energy rtol
    1e-13)."""
    j_cfg, t_cfg, j_params, t_params = model_pair("gemma3-1b", "kernel")
    j_eng = JServeEngine(j_build(j_cfg), max_len=14, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=14, batch_size=BATCH,
                         device="cpu")
    j_eng.generate = functools.partial(j_eng.generate, clock=SteppingClock())
    t_eng.generate = functools.partial(t_eng.generate, clock=SteppingClock())
    kw = dict(level_accuracies=[0.7], n_streams=3, profile_iters=2,
              gen_tokens=4, prompt_len=10, start_active=False)
    j_srv = js.FleetAlertServer(j_eng, j_params,
                                goal=jc.Goal.MINIMIZE_ENERGY, **kw)
    t_srv = ts.FleetAlertServer(t_eng, t_params,
                                goal=tc.Goal.MINIMIZE_ENERGY, **kw)
    np.testing.assert_array_equal(t_srv.table.latency, j_srv.table.latency)
    tenants = [("min", 0.05, 0.6, None), ("max", 0.045, None, 4.0),
               ("min", 0.035, 0.65, None)]
    for goal, deadline, ag, eg in tenants:
        lanes = [srv.admit(mod.Goal.MINIMIZE_ENERGY if goal == "min"
                           else mod.Goal.MAXIMIZE_ACCURACY,
                           mod.Constraints(deadline=deadline,
                                           accuracy_goal=ag, energy_goal=eg))
                 for srv, mod in ((j_srv, jc), (t_srv, tc))]
        assert lanes[0] == lanes[1]
    prompts = [np.random.default_rng(s).integers(0, t_cfg.vocab, (BATCH, 10))
               .astype(np.int32) for s in range(3)]
    for _ in range(2):
        t_out = t_srv.serve_tick(prompts)
        j_out = j_srv.serve_tick(prompts)
        for t, j in zip(t_out, j_out, strict=True):
            assert (t is None) == (j is None)
            if t is None:
                continue
            for f in ("level", "power_cap", "latency", "missed", "accuracy",
                      "feasible"):
                assert getattr(t, f) == getattr(j, f), (f, t, j)
            np.testing.assert_allclose(t.energy, j.energy, rtol=1e-13,
                                       atol=0)
