"""The port's attention kernels against the JAX package on the CPU.

``flash_attention_plain`` and ``decode_attention_plain`` (what the
wrappers run on CPU tensors) are held to the reference's Pallas kernels
run in interpret mode, as ``tests/test_kernels.py`` runs them, and to
``repro.kernels.ref``; shapes the Pallas kernels cannot tile (``S`` not a
multiple of the block) to ``ref`` only.  Every geometry here gives each
query row at least one live key, so every row is compared: the port's
versions give a row with no live key 0, the Pallas kernels a mean of v.

Tolerances: float32 rtol = atol = 2e-5 (float32 throughout, sums in
other orders); bfloat16 rtol = atol = 2e-2, the bar ``tests/test_kernels.py``
holds the Pallas kernels to against ``ref`` (p is rounded to bf16 at a
running maximum in the kernels and at the row maximum in the plain
version, and ``ref`` does not round it at all).

At model level the reduced anytime LM with ``attn_backend="kernel"`` (on
the CPU: the plain versions) is held to the reference's ``lm_apply`` on
the same weights and to the port's own ``attn_backend="ref"``, rtol =
atol = 1e-5 as in ``tests/test_torch_model.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import alert_anytime as j_cfgs
from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as j_decode
from repro.kernels.flash_attention import flash_attention as j_flash
from repro.models import transformer as jt
from repro.serving.engine import ServeEngine as JServeEngine
from repro.models.registry import build_model as j_build
from repro_torch.configs import alert_anytime as t_cfgs
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving.engine import ServeEngine as TServeEngine

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MODEL_TOL = dict(rtol=1e-5, atol=1e-5)

# (b, s, h, kv, hd, causal, window, softcap): tests/test_kernels.py's
# geometries, its softcap case, and the served head_dim 96.
FLASH = [
    (2, 64, 4, 4, 32, True, None, None),
    (1, 128, 8, 2, 16, True, None, None),      # GQA 4:1
    (2, 64, 4, 1, 32, True, None, None),       # MQA
    (1, 64, 2, 2, 32, False, None, None),      # bidirectional
    (1, 128, 4, 4, 32, True, 32, None),        # sliding window
    (1, 64, 2, 2, 32, True, None, 20.0),       # softcap
    (2, 32, 2, 2, 96, True, None, None),       # alert-anytime-120m's hd
]
# (b, s, h, kv, hd, cache_len, window)
DECODE = [
    (2, 256, 4, 4, 32, (256, 100), None),
    (1, 512, 8, 2, 16, (300,), None),
    (2, 128, 4, 1, 32, (64, 128), None),
    (1, 256, 4, 4, 64, (1,), None),            # fresh cache
    (2, 128, 4, 2, 96, 77, None),              # scalar cache_len
    (1, 256, 4, 4, 32, (200,), 64),            # window
]


def _qkv(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(q_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32),
            rng.standard_normal(kv_shape).astype(np.float32))


def _as(dtype, *arrays):
    """(jax arrays, torch tensors) of ``arrays`` in ``dtype``."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _close(got: torch.Tensor, want, dtype: str) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("geometry", FLASH,
                         ids=[f"g{i}" for i in range(len(FLASH))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_reference_kernel(geometry, dtype):
    b, s, h, kv, hd, causal, window, softcap = geometry
    arrays = _qkv(s + h + hd, (b, s, h, hd), (b, s, kv, hd))
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, *arrays)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention_plain(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == (b, s, h, hd)
    _close(got, j_flash(jq, jk, jv, bq=32, bk=32, interpret=True, **kw),
           dtype)
    _close(got, ref.flash_attention_ref(jq, jk, jv, **kw), dtype)


@pytest.mark.parametrize("s,h,kv,hd,causal,window", [
    (37, 4, 2, 96, True, None), (45, 3, 1, 8, True, 7),
    (19, 2, 2, 64, False, None), (50, 4, 4, 256, False, 9)])
def test_flash_plain_ragged_matches_ref(s, h, kv, hd, causal, window):
    """Lengths the Pallas kernel cannot tile (``S % 32 != 0``)."""
    arrays = _qkv(s, (2, s, h, hd), (2, s, kv, hd))
    (jq, jk, jv), (tq, tk, tv) = _as("float32", *arrays)
    got = fa.flash_attention(tq, tk, tv, causal=causal, window=window)
    _close(got, ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                        window=window), "float32")


@pytest.mark.parametrize("geometry", DECODE,
                         ids=[f"g{i}" for i in range(len(DECODE))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_reference_kernel(geometry, dtype):
    b, s, h, kv, hd, lens, window = geometry
    arrays = _qkv(s + h + hd, (b, h, hd), (b, s, kv, hd))
    (jq, jk, jv), (tq, tk, tv) = _as(dtype, *arrays)
    if isinstance(lens, int):
        j_len, t_len = jnp.asarray(lens, jnp.int32), lens
    else:
        j_len = jnp.asarray(lens, jnp.int32)
        t_len = torch.tensor(lens, dtype=torch.int32)
    got = da.decode_attention_plain(tq, tk, tv, t_len, window=window)
    assert got.dtype == tq.dtype and got.shape == (b, h, hd)
    _close(got, j_decode(jq, jk, jv, j_len, window=window, bk=64,
                         interpret=True), dtype)
    _close(got, ref.decode_attention_ref(jq, jk, jv, j_len, window=window),
           dtype)


@functools.lru_cache(maxsize=None)
def _decode_references(geometry, dtype):
    """(torch inputs, Pallas interpret-mode output, ``ref`` output) of a
    ``DECODE`` geometry, computed once for every split count."""
    b, s, h, kv, hd, lens, window = geometry
    arrays = _qkv(s + h + hd, (b, h, hd), (b, s, kv, hd))
    (jq, jk, jv), tqkv = _as(dtype, *arrays)
    j_len = jnp.asarray(lens, jnp.int32)
    t_len = lens if isinstance(lens, int) else torch.tensor(lens,
                                                            dtype=torch.int32)
    return (tqkv, t_len,
            j_decode(jq, jk, jv, j_len, window=window, bk=64, interpret=True),
            ref.decode_attention_ref(jq, jk, jv, j_len, window=window))


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("geometry", DECODE,
                         ids=[f"g{i}" for i in range(len(DECODE))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_plain_matches_reference_kernel(geometry, dtype,
                                                     splits):
    """The split kernel's arithmetic (per-split partials and the combine)
    against the unsplit plain version, the Pallas kernel in interpret mode
    and ``ref``; 7 splits of a 4-tile cache leave runs with no position."""
    (tq, tk, tv), t_len, pallas, want = _decode_references(geometry, dtype)
    window = geometry[-1]
    got = da.decode_attention_split_plain(tq, tk, tv, t_len, window=window,
                                          splits=splits)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, da.decode_attention_plain(tq, tk, tv, t_len,
                                          window=window).float(), dtype)
    _close(got, pallas, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("splits", [2, 3, 7, 40])
def test_decode_split_plain_empty_runs_window_and_empty_row(splits):
    """Per-row lengths with a window whose range starts inside a tile, a
    row with ``cache_len`` 0 (0 from every split count, never NaN), a row
    past the cache and runs that see no live position: equal to the
    unsplit plain version, and to ``ref`` on the rows with live keys."""
    arrays = _qkv(splits, (4, 6, 32), (4, 300, 2, 32))
    (jq, jk, jv), (tq, tk, tv) = _as("float32", *arrays)
    lens = [300, 0, 77, 320]
    for window in (None, 45):
        got = da.decode_attention_split_plain(
            tq, tk, tv, torch.tensor(lens), window=window, splits=splits)
        assert torch.equal(got[1], torch.zeros_like(got[1]))
        _close(got, da.decode_attention_plain(tq, tk, tv, torch.tensor(lens),
                                              window=window), "float32")
        want = np.asarray(ref.decode_attention_ref(
            jq, jk, jv, jnp.asarray(lens), window=window))
        _close(got[[0, 2, 3]], want[[0, 2, 3]], "float32")


@pytest.mark.parametrize("b,n_kv,g,s,window", [
    (4, 8, 1, 12, None),           # the served shapes
    (4, 1, 4, 32768, None),        # (c) gemma3-1b, global
    (4, 1, 4, 32768, 512),         # (c) window
    (4, 8, 1, 2048, None),         # (b)
    (1, 1, 8, 32768, None),        # B=1, 8 query heads on one kv head
    (3, 2, 3, 4096, 300),          # GQA 3:1 with a window
    (64, 8, 1, 2048, None),        # a grid that already fills the card
    (2, 1, 1, 0, None),            # an empty cache
])
def test_decode_split_plan(b, n_kv, g, s, window):
    """Whole tiles per split, the splits of the longest row covering every
    tile it touches, each with at least one; one split at the served
    shapes; at least 2 x n_sm blocks at (c) for n_sm = 132."""
    n_sm = 132
    splits, most = da.decode_split_plan(b, n_kv, g, s, window, n_sm)
    tiles = max(da.max_row_tiles(s, window), 1)
    assert isinstance(splits, int) and isinstance(most, int)
    assert 1 <= splits <= tiles
    runs = [(j + 1) * tiles // splits - j * tiles // splits
            for j in range(splits)]
    assert sum(runs) == tiles and min(runs) >= 1 and max(runs) == most
    base = b * n_kv * -(-g // da.heads_per_block(g))
    if (b, s) == (4, 12):
        assert splits == 1
    if s == 32768 and window is None:
        assert splits * base >= 2 * n_sm
    assert splits * base <= max(4 * n_sm, base)


def test_split_workspace_bytes():
    assert da.decode_attention_workspace_bytes(4, 12, 8, 8, 96,
                                               n_sm=132) == 0
    splits, _ = da.decode_split_plan(4, 1, 4, 32768, None, 132)
    assert splits > 1
    assert da.decode_attention_workspace_bytes(
        4, 32768, 4, 1, 256, n_sm=132) == 4 * 4 * 4 * splits * 258


def test_decode_plain_ragged_matches_ref():
    """A 77-slot cache (not a multiple of the Pallas block) with per-row
    lengths, and the same through the CPU wrapper with an int."""
    arrays = _qkv(77, (3, 6, 64), (3, 77, 2, 64))
    (jq, jk, jv), (tq, tk, tv) = _as("float32", *arrays)
    lens = [77, 5, 40]
    got = da.decode_attention(tq, tk, tv, torch.tensor(lens))
    _close(got, ref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)),
           "float32")
    got = da.decode_attention(tq, tk, tv, 33, window=20)
    _close(got, ref.decode_attention_ref(jq, jk, jv, 33, window=20),
           "float32")


def test_cpu_wrappers_run_plain_and_count_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, (2, 16, 4, 32),
                                                 (2, 16, 2, 32)))
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    for kw in (dict(), dict(causal=False), dict(window=5, softcap=30.0)):
        assert torch.equal(fa.flash_attention(q, k, v, **kw),
                           fa.flash_attention_plain(q, k, v, **kw))
    for lens, window in ((16, None), (torch.tensor([3, 16]), 4)):
        assert torch.equal(da.decode_attention(q[:, 0], k, v, lens,
                                               window=window),
                           da.decode_attention_plain(q[:, 0], k, v, lens,
                                                     window=window))
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        da.decode_attention(q[:, 0].to("meta"), k.to("meta"), v.to("meta"),
                            16)


def test_ops_nested_matmul_backends():
    """``ops`` re-exports the wrappers themselves, with no backend switch;
    on CPU tensors ``ops.nested_matmul`` is the plain version."""
    from repro_torch.core.nesting import StripeSpec
    from repro_torch.kernels import nested_matmul as nm

    assert (ops.nested_matmul, ops.flash_attention, ops.decode_attention) \
        == (nm.nested_matmul, fa.flash_attention, da.decode_attention)
    spec = StripeSpec.pow2(64, 3)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    want = nm.nested_matmul_plain(x, w, spec, spec, 2)
    assert torch.equal(ops.nested_matmul(x, w, spec, spec, 2), want)
    with pytest.raises(TypeError):
        ops.nested_matmul(x, w, spec, spec, 2, backend="ref")


def test_fully_masked_rows_come_out_zero():
    """No live key: 0 from both plain versions (not the Pallas kernels'
    mean of v), never NaN."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, (1, 8, 2, 8),
                                                 (1, 8, 2, 8)))
    out = fa.flash_attention_plain(q, k, v, causal=True, window=1)
    assert torch.isfinite(out).all()
    # two keys, causal, window 3: rows 4..7 would need a key >= 2
    out = fa.flash_attention_plain(q, k[:, :2], v[:, :2], causal=True,
                                   window=3)
    assert torch.equal(out[:, 4:], torch.zeros_like(out[:, 4:]))
    assert bool((out[:, :4] != 0).any(dim=-1).all())
    d = da.decode_attention_plain(q[:, 0], k, v, torch.tensor([0]))
    assert torch.equal(d, torch.zeros_like(d))


@pytest.mark.parametrize("bad", ["hd12", "hd264", "float16", "gqa",
                                 "window0", "mixed"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    shapes = {"hd12": (4, 12), "hd264": (4, 264)}
    h, hd = shapes.get(bad, (4, 32))
    kv = 3 if bad == "gqa" else 2
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, (1, 8, h, hd),
                                                 (1, 8, kv, hd)))
    window = 0 if bad == "window0" else None
    if bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    if bad == "mixed":
        k = k.bfloat16()
    with pytest.raises(ValueError, match="flash_attention"):
        fa.flash_attention(q, k, v, window=window)
    with pytest.raises(ValueError, match="decode_attention"):
        da.decode_attention(q[:, 0], k, v, 8, window=window)


@pytest.mark.parametrize("s,dtype", [(2048, "bfloat16"), (2048, "float32"),
                                     (32768, "float32")])
def test_smoke_tolerance_rejects_a_dropped_tile(s, dtype):
    """``chip_smoke.attention_close`` (the card check of both kernels)
    passes the plain version against itself and fails an output that
    dropped one 32-position tile of the cache, at gemma3-1b's decode
    geometry."""
    from chip_smoke import SmokeFailure, attention_close

    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _qkv(s, (2, 4, 256), (2, s, 1, 256)))
    want = da.decode_attention_plain(q, k, v, s)
    vscale = da.decode_attention_plain(q.float(), k.float(),
                                       v.float().abs(), s)
    assert attention_close(want, want, vscale, dtype, "same") == (0.0, 0.0)
    dropped = da.decode_attention_plain(q, k, v, s - 32)
    with pytest.raises(SmokeFailure, match="the tolerance"):
        attention_close(dropped, want, vscale, dtype, "dropped tile")
    # a combine that drops the middle split of the kernel's plan (n_sm
    # 132): attention over the cache without that split's positions
    splits, _ = da.decode_split_plan(2, 1, 4, s, None, 132)
    assert splits > 1
    n, j = s // da.TILE, splits // 2
    lo, hi = j * n // splits * da.TILE, (j + 1) * n // splits * da.TILE
    dropped = da.decode_attention_plain(
        q, torch.cat([k[:, :lo], k[:, hi:]], 1),
        torch.cat([v[:, :lo], v[:, hi:]], 1), s - (hi - lo))
    with pytest.raises(SmokeFailure, match="the tolerance"):
        attention_close(dropped, want, vscale, dtype, "dropped split")


def test_costs_count_live_work():
    c = fa.flash_attention_cost(4, 2048, 2048, 8, 8, 96, torch.bfloat16)
    pairs = 2048 * 2049 // 2
    assert c["live_pairs"] == pairs
    assert c["flops"] == 4 * 4 * 8 * 96 * pairs
    assert c["bytes_accessed"] == 2 * 4 * (2 * 2048 * 8 * 96
                                           + 2 * 2048 * 8 * 96)
    w = fa.flash_attention_cost(1, 4096, 4096, 4, 1, 256, torch.bfloat16,
                                window=512)
    assert w["live_pairs"] == 512 * 513 // 2 + (4096 - 512) * 512
    d = da.decode_attention_cost(4, 2048, 8, 8, 96, torch.bfloat16,
                                 torch.tensor([2048, 1500, 1024, 517]))
    assert d["live_positions"] == 2048 + 1500 + 1024 + 517
    assert d["bytes_accessed"] == 2 * (2 * 4 * 8 * 96
                                       + 2 * 8 * 96 * d["live_positions"])
    g = da.decode_attention_cost(4, 32768, 4, 1, 256, torch.bfloat16, 32768,
                                 window=512)
    assert g["live_positions"] == 4 * 512
    assert g["flops"] == 4 * 4 * 256 * 4 * 512


def test_config_attention_fields_match_reference():
    names = ("attn_backend", "attn_logit_softcap")
    for name in names:
        assert getattr(t_cfgs.CONFIG, name) == getattr(j_cfgs.CONFIG, name)
        assert (TModelConfig.__dataclass_fields__[name].default
                == JModelConfig.__dataclass_fields__[name].default)
    with pytest.raises(ValueError, match="attn_backend"):
        t_cfgs.CONFIG.replace(attn_backend="pallas")


# --------------------------------------------------------------------- #
# the model with attn_backend="kernel"                                   #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def models():
    j_cfg = j_cfgs.reduced().replace(dtype="float32")
    t_cfg = t_cfgs.reduced().replace(dtype="float32")
    j_params = jt.init_lm(jax.random.PRNGKey(0), j_cfg)
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    return j_cfg, t_cfg, j_params, t_params


def _run(j_cfg, t_cfgs_, j_params, t_params, level, n_decode, seed):
    """Prefill and ``n_decode`` KV-cached steps on the reference and on
    each port config in ``t_cfgs_``; returns the per-step logits."""
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, j_cfg.vocab, (2, 6)).astype(np.int32)
    steps = rng.integers(0, j_cfg.vocab, (n_decode, 2, 1)).astype(np.int32)
    max_len = 6 + n_decode
    j_eng = JServeEngine(j_build(j_cfg), max_len=max_len, batch_size=2)
    j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(prompt),
                        mode="prefill", level=level)
    want = [np.asarray(j_out.logits)]
    caches = j_eng._merge(j_eng.init_caches(level), j_out.caches)
    for i in range(n_decode):
        o = jt.lm_apply(j_params, j_cfg, jnp.asarray(steps[i]),
                        mode="decode", caches=caches,
                        cache_len=jnp.asarray(6 + i, jnp.int32), level=level)
        caches = o.caches
        want.append(np.asarray(o.logits))
    got = []
    for cfg in t_cfgs_:
        eng = TServeEngine(t_build(cfg), max_len=max_len, batch_size=2,
                           device="cpu")
        with torch.inference_mode():
            out = tt.lm_apply(t_params, cfg, torch.from_numpy(prompt).long(),
                              mode="prefill", level=level)
            logits = [out.logits.numpy()]
            caches = eng._merge(eng.init_caches(level), out.caches)
            for i in range(n_decode):
                o = tt.lm_apply(t_params, cfg,
                                torch.from_numpy(steps[i]).long(),
                                mode="decode", caches=caches,
                                cache_len=6 + i, level=level)
                caches = o.caches
                logits.append(o.logits.numpy())
        got.append(logits)
    return want, got


@pytest.mark.parametrize("level", [1, 2, 3])
def test_kernel_attention_model_matches_reference(models, level):
    """Prefill and three decode steps: ``attn_backend="kernel"`` (with
    each nest backend) against the reference and the port's ``ref``."""
    j_cfg, t_cfg, j_params, t_params = models
    cfgs = [t_cfg.replace(attn_backend="kernel"),
            t_cfg.replace(attn_backend="kernel", nest_backend="kernel"),
            t_cfg]
    want, (kern, kern_nm, plain) = _run(j_cfg, cfgs, j_params, t_params,
                                        level, 3, seed=20 + level)
    for w, a, b, c in zip(want, kern, kern_nm, plain):
        np.testing.assert_allclose(a, w, **MODEL_TOL)
        np.testing.assert_allclose(b, w, **MODEL_TOL)
        np.testing.assert_allclose(a, c, **MODEL_TOL)


def test_softcap_prefill_on_kernel_and_decode_raises(models):
    """With ``attn_logit_softcap`` both backends match the reference (the
    softcap reaches the prefill kernel); the kernel backend's decode
    raises, since neither decode kernel has a softcap."""
    j_cfg, t_cfg, j_params, t_params = models
    j_cfg = j_cfg.replace(attn_logit_softcap=0.5)
    ref_cfg = t_cfg.replace(attn_logit_softcap=0.5)
    kern_cfg = ref_cfg.replace(attn_backend="kernel")
    want, (plain,) = _run(j_cfg, [ref_cfg], j_params, t_params, 3, 2,
                          seed=5)
    for w, c in zip(want, plain):
        np.testing.assert_allclose(c, w, **MODEL_TOL)
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, j_cfg.vocab, (2, 6)))
    out = tt.lm_apply(t_params, kern_cfg, prompt, mode="prefill", level=3)
    np.testing.assert_allclose(out.logits.numpy(), want[0], **MODEL_TOL)
    eng = TServeEngine(t_build(kern_cfg), max_len=8, batch_size=2,
                       device="cpu")
    caches = eng._merge(eng.init_caches(3), out.caches)
    with pytest.raises(ValueError, match="no logit softcap"):
        tt.lm_apply(t_params, kern_cfg, prompt[:, :1], mode="decode",
                    caches=caches, cache_len=6, level=3)
