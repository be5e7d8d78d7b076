"""The port's hybrid family against the JAX package on the CPU:
``jamba-v0.1-52b``, Mamba layers beside attention and MoE.

Config level: the layer plan and period of the full config (period 8), of
its first 16 layers (two periods) and of ``reduced()`` (8 layers: period
6 plus two), ``param_count`` and ``active_param_count`` as the reference
counts them, and the reference's ``conv_b`` gap (the tensors hold
``d_inner`` more parameters a Mamba layer than the count says).

Block level, on the same numpy inputs from a seed: ``_causal_conv`` with
and without a tail, ``mamba`` at S = 1, 2, 15, 16 and 20 with
``mamba_chunk`` 16 (20 pads the reference's last chunk), from zeros and
from a state, output and both state leaves; a prefill followed by decode
steps equal to one longer prefill (a hypothesis test); ``softplus``
against ``jax.nn.softplus`` over [-40, 40]; the block in bf16.

Model level: reduced Jamba in float32 with the reference's weights
(``params_from_jax``), prefill and 3 decode steps in both attention
backends, every cache and every layer's routed expert ids equal (the
reference runs unrolled, ``unroll_layers=True``, so its router sees
concrete arrays; that changes no number); bf16 conversion bitwise, the
float32 Mamba leaves included; the 16-layer plan's unstacking; engine and
fleet server against the reference's.

Tolerance: float32 on both sides, summed in other orders, so outputs agree
to about 4e-6; the tests hold them to rtol = atol = 1e-5, as
``tests/test_torch_moe.py`` does.  The bf16 block is held to the
reference's bf16 block with an absolute tolerance of 2**-5 times the
largest magnitude of the reference's tensor: the two frameworks round
the bf16 intermediates at other places (XLA keeps some in float32 within a
fusion), and over 30 seeds the worst difference measured 2**-5.8 of that
magnitude for the output and 2**-6.0 for the SSM state.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core import controller as jc
from repro.models import mamba as jmb
from repro.models import moe as jm
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.serving import alert_server as js
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import controller as tc
from repro_torch.models import mamba as tmb
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import alert_server as ts
from repro_torch.serving.engine import ServeEngine as TServeEngine
from tests._hypothesis_compat import given, settings, st

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_SCALE = 2.0 ** -5
PROMPT_LEN, N_DECODE, BATCH = 12, 3, 2
MAX_LEN = PROMPT_LEN + N_DECODE


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.fixture
def routes(monkeypatch):
    """Records the ids every ``route_topk`` call returns, on both sides:
    ``routes["j"]`` and ``routes["t"]``, lists in call order."""
    seen = {"j": [], "t": []}
    for side, mod in (("j", jm), ("t", tm)):
        plain = mod.route_topk

        def rec(logits, k, plain=plain, side=side):
            out = plain(logits, k)
            seen[side].append(np.asarray(out[1]))
            return out
        monkeypatch.setattr(mod, "route_topk", rec)
    return seen


# --------------------------------------------------------------------- #
# configs                                                                #
# --------------------------------------------------------------------- #
PLANS = {"full": ({}, 8), "16-layers": ({"n_layers": 16}, 8),
         "reduced": (None, 6)}


def plan_pair(which):
    kw, _ = PLANS[which]
    if kw is None:
        return get_reduced(ARCH), j_get_reduced(ARCH)
    return get_config(ARCH).replace(**kw), j_get_config(ARCH).replace(**kw)


@pytest.mark.parametrize("which", list(PLANS))
def test_layer_plan_and_period_equal_reference(which):
    t, j = plan_pair(which)
    assert t.layer_plan() == j.layer_plan()
    assert t.layer_period() == j.layer_period() == PLANS[which][1]
    attn = [i for i in range(t.n_layers) if t.mixer_kind(i) == "attn"]
    assert attn == [i for i in range(t.n_layers) if i % 8 == 4]
    assert [t.ffn_kind(i) for i in range(t.n_layers)] == \
        ["moe" if i % 2 else "dense" for i in range(t.n_layers)]


@pytest.mark.parametrize("which", list(PLANS))
def test_param_count_equals_reference(which):
    t, j = plan_pair(which)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.mamba_d_inner, t.mamba_dt_rank_actual) == \
        (j.mamba_d_inner, j.mamba_dt_rank_actual)


def tensor_count(j_cfg) -> int:
    """Parameters the reference's ``init_lm`` tensors hold at ``j_cfg``
    (shapes only: ``jax.eval_shape``, nothing allocated)."""
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax.eval_shape(lambda: jt.init_lm(jax.random.PRNGKey(0), j_cfg))))


def test_published_size():
    """51,570,085,888 parameters (103.1 GB in bf16) and 26,053,480,448 in
    the first 16 layers, as the reference counts them."""
    assert get_config(ARCH).param_count() == 51_570_085_888
    assert get_config(ARCH).replace(n_layers=16).param_count() == \
        26_053_480_448


@pytest.mark.parametrize("which", ["16-layers", "reduced"])
def test_param_count_leaves_out_conv_b(which):
    """The reference's count leaves out ``conv_b``: the tensors hold
    ``d_inner`` parameters more a Mamba layer than ``param_count`` says,
    7 x 128 at ``reduced()`` (where the port's own ``init_lm`` holds as
    many) and 14 x 8192 in 16 full-width layers (26,053,595,136: 52.1 GB
    in bf16)."""
    t, j = plan_pair(which)
    n_mamba = sum(m == "mamba" for m, _ in t.layer_plan())
    gap = {"16-layers": 14 * 8192, "reduced": 7 * 128}[which]
    assert n_mamba * t.mamba_d_inner == gap
    assert tensor_count(j) == t.param_count() + gap
    if which == "16-layers":
        assert tensor_count(j) == 26_053_595_136
        return
    params = tt.init_lm(t, torch.Generator().manual_seed(0), device="cpu")
    assert sum(w.numel() for w in [params["embed"], params["unembed"],
                                   params["final_norm"]]
               + [w for layer in params["layers"]
                  for part in layer.values() for w in part.values()]) == \
        t.param_count() + gap


def test_hybrid_needs_no_nesting():
    with pytest.raises(ValueError, match="hybrid models without width"):
        get_reduced(ARCH).replace(n_experts=0, top_k=0, nest_levels=2)


# --------------------------------------------------------------------- #
# the Mamba block                                                        #
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def block_pair(dtype="float32"):
    """(j_cfg, t_cfg, j_params, t_params) of one reduced Mamba block."""
    j_cfg = j_get_reduced(ARCH).replace(dtype=dtype)
    t_cfg = get_reduced(ARCH).replace(dtype=dtype)
    j_params = jmb.mamba_init(jax.random.PRNGKey(3), j_cfg)
    # non-zero biases and skip, so a missing add or cast would show
    rng = np.random.default_rng(3)
    j_params = dict(j_params)
    for name in ("conv_b", "dt_bias", "d_skip"):
        j_params[name] = jnp.asarray(rng.standard_normal(
            j_params[name].shape).astype(np.float32) * 0.5)
    t_params = params_from_jax(
        {"embed": np.zeros((1, 1), np.float32),
         "final_norm": np.zeros(1, np.float32),
         "rem0": {"mixer": jax.tree.map(np.asarray, j_params), "ffn": {}}},
        t_cfg.replace(n_layers=1), device="cpu")["layers"][0]["mixer"]
    return j_cfg, t_cfg, j_params, t_params


@functools.lru_cache(maxsize=None)
def j_mamba(cfg):
    return jax.jit(lambda p, x, st: jmb.mamba(p, x, cfg, state=st))


def inputs(b, s, d, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        dtype)


def random_state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, cfg.mamba_d_inner, cfg.mamba_d_state))
            .astype(np.float32),
            rng.standard_normal((b, cfg.mamba_d_conv - 1,
                                 cfg.mamba_d_inner)).astype(np.float32))


@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("s", [1, 2, 3, 7])
def test_causal_conv_matches_reference(s, with_tail):
    """Output and new tail, with the prompt shorter than, as long as and
    longer than ``d_conv - 1`` = 3."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    tail = rng.standard_normal((2, 3, 8)).astype(np.float32) \
        if with_tail else None
    j_out, j_tail = jmb._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if tail is None else jnp.asarray(tail))
    t_out, t_tail = tmb._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        None if tail is None else torch.from_numpy(tail))
    close(t_out, j_out)
    np.testing.assert_array_equal(t_tail.numpy(), np.asarray(j_tail))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 2, 15, 16, 20])
def test_mamba_matches_reference(s, with_state):
    """Output, SSM state and conv tail within 1e-5 at ``mamba_chunk`` 16:
    one chunk, a whole chunk, and 20 tokens (the reference pads its last
    chunk with delta = 0)."""
    j_cfg, t_cfg, j_p, t_p = block_pair()
    assert t_cfg.mamba_chunk == 16
    x = inputs(2, s, t_cfg.d_model, seed=s)
    st_np = random_state(t_cfg, 2, seed=s) if with_state else None
    j_st = None if st_np is None else jmb.MambaState(*map(jnp.asarray,
                                                          st_np))
    t_st = None if st_np is None else tmb.MambaState(*map(torch.from_numpy,
                                                          st_np))
    j_out, j_new = j_mamba(j_cfg)(j_p, jnp.asarray(x), j_st)
    t_out, t_new = tmb.mamba(t_p, torch.from_numpy(x), t_cfg, state=t_st)
    close(t_out, j_out)
    close(t_new.ssm, j_new.ssm)
    close(t_new.conv, j_new.conv)
    assert t_new.ssm.dtype == torch.float32
    assert t_new.conv.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mamba_bf16_matches_reference(seed):
    """The block in bf16, its float32 leaves float32: output and conv tail
    bf16, SSM state float32, each within 2**-5 of its largest magnitude
    of the reference's bf16 block (module docstring)."""
    j_cfg, t_cfg, j_p, t_p = block_pair("bfloat16")
    assert {n for n, w in t_p.items() if w.dtype == torch.float32} == \
        set(tmb.FLOAT32_PARAMS)
    x = inputs(2, 20, t_cfg.d_model, seed=seed)
    j_out, j_new = j_mamba(j_cfg)(j_p, jnp.asarray(x, jnp.bfloat16), None)
    t_out, t_new = tmb.mamba(t_p, torch.from_numpy(x).to(torch.bfloat16),
                             t_cfg)
    assert t_out.dtype == t_new.conv.dtype == torch.bfloat16
    assert t_new.ssm.dtype == torch.float32
    for got, want in ((t_out, j_out), (t_new.ssm, j_new.ssm),
                      (t_new.conv, j_new.conv)):
        want = np.asarray(want, np.float32)
        close(got, want, dict(rtol=0, atol=BF16_SCALE
                              * float(np.abs(want).max())))


@settings(max_examples=12, deadline=None)
@given(s=st.integers(1, 20), k=st.integers(1, 4),
       seed=st.integers(0, 2 ** 16))
def test_prefill_then_decode_equals_longer_prefill(s, k, seed):
    """A prefill of ``s`` tokens, then ``k`` one-token steps carrying the
    state, gives the outputs and final state of one prefill of ``s + k``
    (the conv tail crosses from prefill to decode, also when ``s`` is
    shorter than ``d_conv - 1``)."""
    _, t_cfg, _, t_p = block_pair()
    x = torch.from_numpy(inputs(2, s + k, t_cfg.d_model, seed=seed))
    whole, whole_st = tmb.mamba(t_p, x, t_cfg)
    out, state = tmb.mamba(t_p, x[:, :s], t_cfg)
    outs = [out]
    for t in range(s, s + k):
        o, state = tmb.mamba(t_p, x[:, t:t + 1], t_cfg, state=state)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, dim=1), whole, **TOL)
    torch.testing.assert_close(state.ssm, whole_st.ssm, **TOL)
    torch.testing.assert_close(state.conv, whole_st.conv, rtol=0, atol=0)


def test_softplus_matches_jax():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port's agrees over
    [-40, 40] in float32, past torch's own threshold of 20 included."""
    x = np.linspace(-40, 40, 16001, dtype=np.float32)
    got = tmb.softplus(torch.from_numpy(x))
    want = jax.nn.softplus(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                               atol=0)


def test_port_init_keeps_four_leaves_float32():
    cfg = get_reduced(ARCH)
    p = tmb.mamba_init(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    assert {n: tuple(w.shape) for n, w in p.items()} == \
        tmb.mamba_param_shapes(cfg)
    assert {n for n, w in p.items() if w.dtype == torch.float32} == \
        set(tmb.FLOAT32_PARAMS)
    j = jmb.mamba_init(jax.random.PRNGKey(0), j_get_reduced(ARCH))
    for name in ("a_log", "d_skip", "conv_b", "dt_bias", "norm"):
        np.testing.assert_array_equal(p[name].float().numpy(),
                                      np.asarray(j[name], np.float32))


# --------------------------------------------------------------------- #
# conversion                                                             #
# --------------------------------------------------------------------- #
def test_convert_bf16_is_bitwise():
    """The reference's bf16 pytree of reduced Jamba (period 6: ``pos0..
    pos5`` x 1, then ``rem0`` and ``rem1``): every leaf of every layer is
    the reference's, bitwise, the float32 Mamba leaves and routers still
    float32."""
    cfg, j_cfg = get_reduced(ARCH), j_get_reduced(ARCH)
    j_params = jax.tree.map(np.asarray, jt.init_lm(jax.random.PRNGKey(0),
                                                   j_cfg))
    assert sorted(k for k in j_params if k.startswith("rem")) == \
        ["rem0", "rem1"] and len(j_params["group"]) == 6
    layers = params_from_jax(j_params, cfg, device="cpu")["layers"]
    want = [jax.tree.map(lambda a: a[0], j_params["group"][f"pos{p}"])
            for p in range(6)] + [j_params["rem0"], j_params["rem1"]]
    keep32 = set(tmb.FLOAT32_PARAMS) | {"router"}
    for i, (layer, ref) in enumerate(zip(layers, want, strict=True)):
        assert ("a_log" in layer["mixer"]) == (cfg.mixer_kind(i) == "mamba")
        for part in ("mixer", "ffn"):
            assert sorted(layer[part]) == sorted(ref[part])
            for name, w in layer[part].items():
                assert w.dtype == (torch.float32 if name in keep32
                                   else torch.bfloat16), name
                np.testing.assert_array_equal(
                    w.float().numpy(), ref[part][name].astype(np.float32))


def test_convert_unstacks_sixteen_layers():
    """16 layers (period 8 x 2 repeats, no remainder): a stand-in pytree
    whose leaves carry their layer's index lands layer ``rep * 8 + pos``
    at ``layers[rep * 8 + pos]``, each where ``mixer_kind`` expects it."""
    cfg = get_reduced(ARCH).replace(n_layers=16)
    assert cfg.layer_period() == 8

    def leaves(idx, mixer):
        name = "a_log" if mixer == "mamba" else "wq"
        return {"mixer": {name: np.asarray(idx, np.float32)},
                "ffn": {"w_up": np.asarray(idx, np.float32)}}

    tree = {"embed": np.zeros((2, 2), np.float32),
            "unembed": np.zeros((2, 2), np.float32),
            "final_norm": np.zeros(2, np.float32),
            "group": {f"pos{p}": leaves(np.arange(2) * 8 + p,
                                        cfg.mixer_kind(p))
                      for p in range(8)}}
    layers = params_from_jax(tree, cfg, device="cpu")["layers"]
    assert len(layers) == 16
    for i, layer in enumerate(layers):
        name = "a_log" if cfg.mixer_kind(i) == "mamba" else "wq"
        assert float(layer["mixer"][name]) == float(layer["ffn"]["w_up"]) \
            == i


# --------------------------------------------------------------------- #
# the model                                                              #
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def model_pair(backend="ref"):
    """(j_cfg, t_cfg, j_params, t_params) of reduced float32 Jamba, the
    same weights on both sides; the reference unrolled."""
    j_cfg = j_get_reduced(ARCH).replace(dtype="float32", unroll_layers=True)
    t_cfg = get_reduced(ARCH).replace(dtype="float32", attn_backend=backend)
    np_params = jax.tree.map(np.asarray,
                             jt.init_lm(jax.random.PRNGKey(0), j_cfg))
    return (j_cfg, t_cfg, jax.tree.map(jnp.asarray, np_params),
            params_from_jax(np_params, t_cfg, device="cpu"))


def check_step(t_out, j_out, routes):
    close(t_out.logits, j_out.logits)
    n = len(t_out.caches)
    for i, tcache in enumerate(t_out.caches):
        jcache = j_out.caches[f"rem{i}"]
        assert type(tcache).__name__ == type(jcache).__name__
        for a, b in zip(tcache, jcache, strict=True):
            close(a, b)
    assert len(routes["t"]) == len(routes["j"]) == n // 2
    for got, want in zip(routes["t"], routes["j"]):
        np.testing.assert_array_equal(got, want)
    routes["t"].clear()
    routes["j"].clear()


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_prefill_and_decode_match_reference(backend, routes):
    """Prefill of 12 tokens, then 3 decode steps: logits, every layer's
    KV cache and Mamba state, and the 4 MoE layers' routed ids."""
    j_cfg, t_cfg, j_params, t_params = model_pair(backend)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    steps = rng.integers(0, t_cfg.vocab, (N_DECODE, BATCH, 1)).astype(
        np.int32)
    j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(prompt), mode="prefill")
    t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(prompt,
                                                         dtype=torch.long))
    check_step(t_out, j_out, routes)
    j_eng = JServeEngine(j_build(j_cfg), max_len=MAX_LEN, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=MAX_LEN, batch_size=BATCH,
                         device="cpu")
    j_caches = j_eng._merge(j_eng.init_caches(None), j_out.caches)
    t_caches = t_eng._merge(t_eng.init_caches(None), t_out.caches)
    for i, tok in enumerate(steps):
        j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(tok), mode="decode",
                            caches=j_caches,
                            cache_len=jnp.asarray(PROMPT_LEN + i, jnp.int32))
        t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(
            tok, dtype=torch.long), mode="decode", caches=t_caches,
            cache_len=PROMPT_LEN + i)
        check_step(t_out, j_out, routes)
        j_caches, t_caches = j_out.caches, t_out.caches


def test_engine_caches_hold_mamba_states():
    """The engine's one level holds a ``MambaState`` (float32 SSM state,
    bf16 conv tail) in each Mamba layer and KV buffers in the attention
    layer; a prefill's state is copied whole into it."""
    cfg = get_reduced(ARCH)
    eng = TServeEngine(t_build(cfg), max_len=MAX_LEN, batch_size=3,
                       device="cpu")
    caches = eng.init_caches(None)
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    for i, c in enumerate(caches):
        if cfg.mixer_kind(i) == "mamba":
            assert isinstance(c, tmb.MambaState)
            assert (tuple(c.ssm.shape), c.ssm.dtype) == \
                ((3, di, ds), torch.float32)
            assert (tuple(c.conv.shape), c.conv.dtype) == \
                ((3, dc - 1, di), torch.bfloat16)
        else:
            assert tuple(c.k.shape) == (3, MAX_LEN, cfg.n_kv_heads,
                                        cfg.head_dim)
    new = tmb.MambaState(torch.ones(3, di, ds),
                         torch.ones(3, dc - 1, di, dtype=torch.bfloat16))
    merged = eng._merge([caches[0]], [new])[0]
    assert merged.ssm is caches[0].ssm and bool((merged.ssm == 1).all())
    assert bool((merged.conv == 1).all())


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_generate_matches_reference(backend):
    """Greedy tokens of ``ServeEngine.generate`` equal the reference
    engine's."""
    j_cfg, t_cfg, j_params, t_params = model_pair(backend)
    prompt = np.random.default_rng(11).integers(
        0, t_cfg.vocab, (BATCH, 10)).astype(np.int32)
    j_eng = JServeEngine(j_build(j_cfg), max_len=16, batch_size=BATCH)
    t_eng = TServeEngine(t_build(t_cfg), max_len=16, batch_size=BATCH,
                         device="cpu")
    j_r = j_eng.generate(j_params, prompt, 6)
    t_r = t_eng.generate(t_params, prompt, 6)
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
    """The fleet server over reduced Jamba with the kernel attention
    backend, profiled with fake clocks on both sides, then two ticks of
    Eq. 4 and Eq. 5 tenants: every served input and every generated token
    equal (energy rtol 1e-13)."""
    j_cfg, t_cfg, j_params, t_params = model_pair("kernel")
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
    for goal, deadline, ag, eg in [("min", 0.05, 0.6, None),
                                   ("max", 0.045, None, 4.0),
                                   ("min", 0.035, 0.65, None)]:
        lanes = [srv.admit(mod.Goal.MINIMIZE_ENERGY if goal == "min"
                           else mod.Goal.MAXIMIZE_ACCURACY,
                           mod.Constraints(deadline=deadline,
                                           accuracy_goal=ag, energy_goal=eg))
                 for srv, mod in ((j_srv, jc), (t_srv, tc))]
        assert lanes[0] == lanes[1]
    prompts = [np.random.default_rng(s).integers(0, t_cfg.vocab, (BATCH, 10))
               .astype(np.int32) for s in range(3)]
    tokens = {"t": [], "j": []}
    for side, eng in (("t", t_eng), ("j", j_eng)):
        gen = eng.generate

        def rec(*a, gen=gen, side=side, **k):
            r = gen(*a, **k)
            tokens[side].append(np.asarray(r["tokens"]))
            return r
        eng.generate = rec
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
    assert len(tokens["t"]) == len(tokens["j"]) > 0
    for got, want in zip(tokens["t"], tokens["j"]):
        np.testing.assert_array_equal(got, want)
