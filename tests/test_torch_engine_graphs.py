"""The serving engine's step functions against the JAX reference's
``ServeEngine``, on the CPU.

On the card the port's engine replays one CUDA graph per (level, prompt
length) for prefill and one per level for decode; here the same step
functions run eagerly over the same static buffers, with ``cache_len`` a
0-d int32 tensor.  So these tests hold the device-``cache_len`` path, the
static caches and their reset between requests, and the step count
(``n_compiles``) to the reference, on the reduced anytime config (every
level, both nest and both attention backends) and the reduced RWKV-6
config, with the reference's weights carried across by ``convert.py``.
Tokens are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import alert_anytime as j_anytime
from repro.configs import rwkv6_3b as j_rwkv
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import alert_anytime as t_anytime
from repro_torch.configs import rwkv6_3b as t_rwkv
from repro_torch.convert import params_from_jax
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import nested_matmul as nm
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import ServeEngine as TServeEngine

BATCH, MAX_LEN = 2, 16
BACKENDS = [("blocks", "ref"), ("kernel", "ref"), ("blocks", "kernel"),
            ("kernel", "kernel")]


def _models(j_mod, t_mod):
    j_cfg = j_mod.reduced().replace(dtype="float32")
    t_cfg = t_mod.reduced().replace(dtype="float32")
    j_params = jt.init_lm(jax.random.PRNGKey(3), j_cfg)
    t_params = params_from_jax(jax.tree.map(np.asarray, j_params), t_cfg,
                               device="cpu")
    return j_cfg, t_cfg, j_params, t_params


@pytest.fixture(scope="module")
def anytime():
    return _models(j_anytime, t_anytime)


@pytest.fixture(scope="module")
def rwkv():
    return _models(j_rwkv, t_rwkv)


def _prompt(vocab, s0, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, (BATCH, s0)).astype(np.int32)


def _engines(models, backends=None):
    j_cfg, t_cfg, _, _ = models
    if backends is not None:
        t_cfg = t_cfg.replace(nest_backend=backends[0],
                              attn_backend=backends[1])
    return (JServeEngine(j_build(j_cfg), max_len=MAX_LEN, batch_size=BATCH),
            TServeEngine(t_build(t_cfg), max_len=MAX_LEN, batch_size=BATCH,
                         device="cpu"))


# (level, prompt length, new tokens) of one request sequence: level
# switches both ways and two prompt lengths, a long one before short ones
REQUESTS = [(3, 8, 5), (1, 5, 4), (2, 8, 6), (3, 5, 3), (1, 8, 5),
            (2, 5, 4), (3, 8, 4)]


@pytest.mark.parametrize("backends", BACKENDS,
                         ids=["-".join(b) for b in BACKENDS])
def test_steps_match_reference_across_level_switches(anytime, backends):
    """Every request of a sequence that switches levels and prompt
    lengths gives the reference's tokens, and the step counts follow the
    reference's trace counts: one prefill per (level, prompt length), one
    decode per level, flat once each was made."""
    _, t_cfg, j_params, t_params = anytime
    j_eng, t_eng = _engines(anytime, backends)
    assert t_eng.levels == j_eng.levels == [1, 2, 3]
    for i, (level, s0, n_new) in enumerate(REQUESTS):
        prompt = _prompt(t_cfg.vocab, s0, seed=i)
        t_r = t_eng.generate(t_params, prompt, n_new, level=level)
        j_r = j_eng.generate(j_params, prompt, n_new, level=level)
        assert t_r["level"] == j_r["level"] == level and t_r["complete"]
        np.testing.assert_array_equal(t_r["tokens"],
                                      np.asarray(j_r["tokens"]))
        assert t_eng.n_compiles() == j_eng.n_compiles(), i
    assert t_eng.n_compiles() == (6, 3)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_long_request_leaves_no_trace_in_a_short_one(anytime, level):
    """A long request, then a short one at the same level, gives the short
    one's tokens from a fresh engine (and the reference's); after the
    short prefill the static caches hold zeros past the prompt, the state
    a fresh ``init_caches`` gives."""
    _, t_cfg, j_params, t_params = anytime
    j_eng, used = _engines(anytime)
    _, fresh = _engines(anytime)
    long_p = _prompt(t_cfg.vocab, 10, seed=20)
    short_p = _prompt(t_cfg.vocab, 4, seed=21)
    used.generate(t_params, long_p, 6, level=level)
    got = used.generate(t_params, short_p, 3, level=level)["tokens"]
    want = fresh.generate(t_params, short_p, 3, level=level)["tokens"]
    ref = np.asarray(j_eng.generate(j_params, short_p, 3,
                                    level=level)["tokens"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    with torch.inference_mode():
        prefill, _, buf = used._steps(t_params, level, 4)
        prefill()
        assert int(buf.cache_len) == 4
        for cache in buf.caches:
            for leaf in cache:
                assert leaf.shape[1] == MAX_LEN
                assert not leaf[:, 4:].any()


def test_rwkv_steps_match_reference_and_reset(rwkv):
    """RWKV-6: the one level's tokens equal the reference's over requests
    of two prompt lengths, a long request leaves no state in a short one
    (the prefill step replaces the static states whole), and the step
    counts follow the reference's."""
    _, t_cfg, j_params, t_params = rwkv
    j_eng, t_eng = _engines(rwkv)
    _, fresh = _engines(rwkv)
    assert t_eng.levels == [None]
    for i, (s0, n_new) in enumerate([(8, 5), (5, 4), (8, 3), (5, 6)]):
        prompt = _prompt(t_cfg.vocab, s0, seed=30 + i)
        t_r = t_eng.generate(t_params, prompt, n_new)
        j_r = j_eng.generate(j_params, prompt, n_new)
        np.testing.assert_array_equal(t_r["tokens"],
                                      np.asarray(j_r["tokens"]))
        assert t_eng.n_compiles() == j_eng.n_compiles()
    assert t_eng.n_compiles() == (2, 1)
    short_p = _prompt(t_cfg.vocab, 5, seed=40)
    np.testing.assert_array_equal(
        t_eng.generate(t_params, short_p, 4)["tokens"],
        fresh.generate(t_params, short_p, 4)["tokens"])


@pytest.mark.parametrize("backends", BACKENDS,
                         ids=["-".join(b) for b in BACKENDS])
def test_decode_with_tensor_cache_len_equals_int(anytime, backends):
    """One decode forward with ``cache_len`` a 0-d int32 tensor equals
    the forward with it as an int: logits and caches bitwise, at every
    level."""
    _, t_cfg, _, t_params = anytime
    cfg = t_cfg.replace(nest_backend=backends[0], attn_backend=backends[1])
    _, eng = _engines(anytime, backends)
    prompt = torch.as_tensor(_prompt(cfg.vocab, 7, seed=50),
                             dtype=torch.long)
    tok = torch.as_tensor(_prompt(cfg.vocab, 1, seed=51), dtype=torch.long)
    with torch.inference_mode():
        for level in eng.levels:
            pre = tt.lm_apply(t_params, cfg, prompt, level=level)
            outs = []
            for cache_len in (7, torch.tensor(7, dtype=torch.int32)):
                caches = eng._merge(eng.init_caches(level), pre.caches)
                outs.append(tt.lm_apply(t_params, cfg, tok, mode="decode",
                                        caches=caches, cache_len=cache_len,
                                        level=level))
            assert torch.equal(outs[0].logits, outs[1].logits)
            for a, b in zip(outs[0].caches, outs[1].caches):
                assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rwkv_decode_with_tensor_cache_len_equals_int(rwkv):
    _, t_cfg, _, t_params = rwkv
    prompt = torch.as_tensor(_prompt(t_cfg.vocab, 6, seed=60),
                             dtype=torch.long)
    tok = torch.as_tensor(_prompt(t_cfg.vocab, 1, seed=61), dtype=torch.long)
    with torch.inference_mode():
        pre = tt.lm_apply(t_params, t_cfg, prompt)
        a, b = (tt.lm_apply(t_params, t_cfg, tok, mode="decode",
                            caches=pre.caches, cache_len=c)
                for c in (6, torch.tensor(6, dtype=torch.int32)))
    assert torch.equal(a.logits, b.logits)
    for sa, sb in zip(a.caches, b.caches):
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


def test_warmup_makes_every_step_and_switches_stay_flat(anytime):
    """``warmup`` makes one prefill step per level for the prompt length
    and one decode step per level; three rounds of level switches after
    it make none, and new ``params`` make them anew."""
    _, t_cfg, _, t_params = anytime
    _, eng = _engines(anytime)
    eng.warmup(t_params, 6)
    assert eng.n_compiles() == (3, 3)
    assert set(eng.steps) == {("prefill", lvl, 6) for lvl in (1, 2, 3)} | \
        {("decode", lvl) for lvl in (1, 2, 3)}
    prompt = _prompt(t_cfg.vocab, 6, seed=70)
    for _ in range(3):
        for level in (3, 1, 2):
            eng.generate(t_params, prompt, 3, level=level)
    assert eng.n_compiles() == (3, 3)
    other = {k: v for k, v in t_params.items()}
    eng.generate(other, prompt, 2, level=1)
    assert eng.n_compiles() == (4, 4)


def test_generate_rejects_what_the_static_buffers_cannot_hold(anytime):
    _, t_cfg, _, t_params = anytime
    _, eng = _engines(anytime)
    with pytest.raises(ValueError, match="batch_size"):
        eng.generate(t_params, _prompt(t_cfg.vocab, 4, 0)[:1], 2, level=1)
    with pytest.raises(ValueError, match="overflow"):
        eng.generate(t_params, _prompt(t_cfg.vocab, 12, 0), 6, level=1)


def test_replayed_step_adds_its_captured_launches(monkeypatch):
    """A replayed step adds, per wrapper, the launches its capture counted
    (a replay runs no Python, so the wrappers cannot count it)."""
    replays = []

    class FakeGraph:
        def replay(self):
            replays.append(1)

    step = engine_mod.Step(lambda: None, torch.device("cpu"), graph=False)
    step.graph, step.launches = FakeGraph(), (28, 0, 4, 0)
    for w in engine_mod.COUNTED:
        monkeypatch.setattr(w, "launches", 10)
    step()
    step()
    assert replays == [1, 1]
    assert nm.nested_matmul.launches == 10 + 56
    assert da.decode_attention.launches == 10 + 8
    assert [w.launches for w in engine_mod.COUNTED] == [66, 10, 18, 10]
