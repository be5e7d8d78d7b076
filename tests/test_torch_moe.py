"""The port's mixture-of-experts FFN and MoE models against the JAX package
on the CPU: ``olmoe-1b-7b`` and ``qwen3-moe-30b-a3b``.

Block level: ``route_topk`` (exact ties included: the lower expert id
first), ``capacity``, ``moe`` (the GShard one-hot dispatch) with no drops,
with forced drops and over several groups, ``moe_gather`` with and without
overflow, and both aux losses, on the same numpy inputs from a seed.
Model level: each ``reduced()`` config in float32 with weights from the
reference's ``init_lm`` carried over by ``params_from_jax``, prefill and
decode in both attention backends, at per-row ``cache_len`` too, every
layer's routed expert ids equal to the reference's (recorded from
``route_topk`` on both sides; the reference runs its layers unrolled,
``unroll_layers=True``, so its router sees concrete arrays; that changes
no number), then ``ServeEngine.generate`` and two ticks of the fleet
server.

Tolerance: float32 on both sides, products and softmax summed in other
orders, so outputs agree to about 1e-6; the tests hold them to rtol =
atol = 1e-5, as ``tests/test_torch_dense.py`` does.  Routed ids, kept
assignments and capacities are integers and must be equal.
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
from repro.models import moe as jm
from repro.models import transformer as jt
from repro.models.registry import build_model as j_build
from repro.serving import alert_server as js
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import controller as tc
from repro_torch.models import moe as tm
from repro_torch.models import transformer as tt
from repro_torch.models.registry import build_model as t_build
from repro_torch.serving import alert_server as ts
from repro_torch.serving.engine import ServeEngine as TServeEngine

ARCHS = ["olmoe-1b-7b", "qwen3-moe-30b-a3b"]
TOL = dict(rtol=1e-5, atol=1e-5)
PROMPT_LEN, N_DECODE, BATCH = 16, 4, 2
MAX_LEN = PROMPT_LEN + N_DECODE


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


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
def test_published_sizes():
    """``param_count`` and ``active_param_count`` of the full configs, as
    the reference counts them."""
    want = {"olmoe-1b-7b": (6_919_096_320, 1_281_951_744),
            "qwen3-moe-30b-a3b": (30_532_110_336, 3_353_020_416)}
    for arch, counts in want.items():
        t, j = get_config(arch), j_get_config(arch)
        assert (t.param_count(), t.active_param_count()) == counts
        assert (j.param_count(), j.active_param_count()) == counts


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_equals_init(arch):
    """At ``reduced()`` the count equals the element count of the port's
    ``init_lm`` and of the reference's, and the dense models' active count
    is their count."""
    t_cfg = get_reduced(arch)
    assert t_cfg.param_count() == j_get_reduced(arch).param_count()
    assert t_cfg.active_param_count() == \
        j_get_reduced(arch).active_param_count()
    params = tt.init_lm(t_cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    n = sum(w.numel() for w in [params["embed"], params["unembed"],
                                params["final_norm"]]
            + [w for layer in params["layers"] for part in layer.values()
               for w in part.values()])
    j_params = jt.init_lm(jax.random.PRNGKey(0), j_get_reduced(arch))
    assert n == t_cfg.param_count() == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(j_params))
    dense = get_reduced("qwen2.5-14b")
    assert dense.active_param_count() == dense.param_count()


@pytest.mark.parametrize("every,offset", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_ffn_kind_and_counts_follow_moe_every(every, offset):
    """``moe_every`` / ``moe_offset`` put MoE at the reference's layers
    (jamba's pattern later), and the counts follow."""
    kw = dict(n_layers=6, moe_every=every, moe_offset=offset)
    t = get_reduced("olmoe-1b-7b").replace(**kw)
    j = j_get_reduced("olmoe-1b-7b").replace(**kw)
    assert t.layer_plan() == j.layer_plan()
    assert [t.ffn_kind(i) for i in range(6)].count("moe") == \
        len(range(offset, 6, every))
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_config_refusals():
    cfg = get_reduced("olmoe-1b-7b")
    with pytest.raises(ValueError, match="MoE config needs top_k"):
        cfg.replace(top_k=0)
    with pytest.raises(ValueError, match="moe_dispatch"):
        cfg.replace(moe_dispatch="sparse")
    with pytest.raises(ValueError, match="without width nesting"):
        cfg.replace(nest_levels=2)
    # no longer refused: family="encdec" without encoder layers is the
    # same MoE LM, as in the reference
    lm = cfg.replace(family="encdec")
    assert lm.layer_plan() == cfg.layer_plan() == \
        j_get_reduced("olmoe-1b-7b").replace(family="encdec").layer_plan()
    params = t_build(lm).init(device="cpu")
    assert "router" in params["layers"][0]["ffn"]


# --------------------------------------------------------------------- #
# route_topk and capacity                                                #
# --------------------------------------------------------------------- #
def route_both(logits, k):
    j = jm.route_topk(jnp.asarray(logits), k)
    t = tm.route_topk(torch.from_numpy(logits), k)
    return t, j


@pytest.mark.parametrize("k", [1, 2, 8])
def test_route_topk_matches_reference(k):
    logits = np.random.default_rng(k).standard_normal((64, 16)).astype(
        np.float32) * 3
    (tv, ti, tp), (jv, ji, jp) = route_both(logits, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    close(tv, jv)
    close(tp, jp)
    assert tp.dtype == torch.float32 and tv.dtype == torch.float32


@pytest.mark.parametrize("k", [1, 2, 3, 8])
def test_route_topk_ties_take_the_lower_id_first(k):
    """Logits in {0, 1, 2} (exact ties in every row, equal probabilities
    on both sides) and rows all equal: the ids are the reference's, the
    lower id first among ties."""
    rng = np.random.default_rng(100 + k)
    logits = rng.integers(0, 3, (96, 8)).astype(np.float32)
    logits[:4] = 0.0
    logits[4] = [2, 1, 2, 1, 2, 1, 2, 1]
    (tv, ti, _), (jv, ji, _) = route_both(logits, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[:4], np.tile(np.arange(k),
                                                          (4, 1)))
    close(tv, jv)


@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 2.0])
@pytest.mark.parametrize("sg,k,e", [(32, 2, 8), (4, 8, 64), (32, 8, 64),
                                    (32, 8, 128), (512, 8, 128), (7, 3, 5)])
def test_capacity_matches_reference(sg, k, e, factor):
    assert tm.capacity(sg, k, e, factor) == jm.capacity(sg, k, e, factor)


# --------------------------------------------------------------------- #
# the MoE block                                                          #
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def block_params(arch):
    """(j_cfg, t_cfg, j_params, t_params) of one float32 MoE block."""
    j_cfg = j_get_reduced(arch).replace(dtype="float32")
    t_cfg = get_reduced(arch).replace(dtype="float32")
    j_params = jm.moe_init(jax.random.PRNGKey(1), j_cfg)
    t_params = {n: torch.from_numpy(np.array(w)) for n, w in
                jax.tree.map(np.asarray, j_params).items()}
    return j_cfg, t_cfg, j_params, t_params


def dropped(idx, n_experts, c, group_size):
    """Assignments dropped at capacity ``c``: per group of
    ``group_size`` tokens of ``idx [T, k]``, each expert's assignments
    past ``c``."""
    idx = np.asarray(idx)
    return int(sum(max(0, n - c)
                   for grp in idx.reshape(-1, group_size * idx.shape[1])
                   for n in np.bincount(grp, minlength=n_experts)))


MOE_CASES = {  # (capacity_factor, group_size, batch, seq, drops or None)
    "roomy": (4.0, 512, 4, 8, False),
    "drops": (0.25, 512, 4, 8, True),
    "groups": (4.0, 8, 4, 8, False),
    "groups-drops": (0.25, 8, 4, 8, True),
    "served-decode": (1.25, 512, 4, 1, None),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, case, routes):
    """Output and aux loss within 1e-5, routed ids equal; the cases drop
    assignments exactly when they say so (a served decode step, 4 tokens
    at capacity 2, may or may not)."""
    factor, gs, b, s, drops = MOE_CASES[case]
    j_cfg, t_cfg, j_params, t_params = block_params(arch)
    j_cfg = j_cfg.replace(capacity_factor=factor)
    t_cfg = t_cfg.replace(capacity_factor=factor)
    x = np.random.default_rng(len(case)).standard_normal(
        (b, s, t_cfg.d_model)).astype(np.float32)
    out, aux = tm.moe(t_params, torch.from_numpy(x), t_cfg, group_size=gs)
    j_out, j_aux = jm.moe(j_params, jnp.asarray(x), j_cfg, group_size=gs)
    np.testing.assert_array_equal(routes["t"][0], routes["j"][0])
    sg = min(gs, b * s)
    c = jm.capacity(sg, j_cfg.top_k, j_cfg.n_experts, factor)
    n_dropped = dropped(routes["j"][0], j_cfg.n_experts, c, sg)
    assert drops is None or (n_dropped > 0) == drops, n_dropped
    close(out, j_out)
    close(aux, j_aux)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32
    lean, none = tm.moe(t_params, torch.from_numpy(x), t_cfg,
                        group_size=gs, with_aux=False)
    assert none is None and torch.equal(lean, out)


def test_moe_groups_need_whole_groups():
    _, t_cfg, _, t_params = block_params("olmoe-1b-7b")
    x = torch.zeros((3, 5, t_cfg.d_model))
    with pytest.raises(ValueError, match="not divisible by group size 8"):
        tm.moe(t_params, x, t_cfg, group_size=8)


@pytest.mark.parametrize("factor", [4.0, 1.25, 0.25])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gather_matches_reference(arch, factor, routes):
    """``moe_gather`` (and ``moe`` under ``moe_dispatch="gather"``):
    output and its aux loss within 1e-5 of the reference's, routed ids
    equal, with and without overflow (4.0 drops nothing, 0.25 drops)."""
    j_cfg, t_cfg, j_params, t_params = block_params(arch)
    j_cfg = j_cfg.replace(capacity_factor=factor, moe_dispatch="gather")
    t_cfg = t_cfg.replace(capacity_factor=factor, moe_dispatch="gather")
    x = np.random.default_rng(3).standard_normal(
        (4, 8, t_cfg.d_model)).astype(np.float32)
    j_out, j_aux = jm.moe_gather(j_params, jnp.asarray(x), j_cfg)
    out, aux = tm.moe_gather(t_params, torch.from_numpy(x), t_cfg)
    np.testing.assert_array_equal(routes["t"][0], routes["j"][0])
    c = jm.capacity(32, j_cfg.top_k, j_cfg.n_experts, factor)
    n_dropped = dropped(routes["j"][0], j_cfg.n_experts, c, 32)
    assert factor == 1.25 or (n_dropped > 0) == (factor < 1), n_dropped
    close(out, j_out)
    close(aux, j_aux)
    via_moe, via_aux = tm.moe(t_params, torch.from_numpy(x), t_cfg)
    assert torch.equal(via_moe, out) and torch.equal(via_aux, aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gather_equals_onehot_without_drops(arch):
    """Where no expert overflows, the two dispatches give the same output
    (within 1e-5: the combine sums in other orders)."""
    _, t_cfg, _, t_params = block_params(arch)
    t_cfg = t_cfg.replace(capacity_factor=4.0)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 8, t_cfg.d_model)).astype(np.float32))
    onehot, _ = tm.moe(t_params, x, t_cfg)
    gather, _ = tm.moe(t_params, x, t_cfg.replace(moe_dispatch="gather"))
    torch.testing.assert_close(gather, onehot, **TOL)


def test_moe_is_deterministic_and_takes_bf16():
    """bf16 activations with the float32 router: the output is bf16, and
    two calls are bitwise equal."""
    _, t_cfg, _, t_params = block_params("qwen3-moe-30b-a3b")
    cfg = t_cfg.replace(dtype="bfloat16")
    params = {n: w if n == "router" else w.to(torch.bfloat16)
              for n, w in t_params.items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 8, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    for dispatch in ("onehot", "gather"):
        c = cfg.replace(moe_dispatch=dispatch)
        a, _ = tm.moe(params, x, c)
        b, _ = tm.moe(params, x, c)
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


# --------------------------------------------------------------------- #
# init and conversion                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_keeps_the_router_float32(arch):
    cfg = get_reduced(arch)
    layer = tt.init_lm(cfg, torch.Generator().manual_seed(0),
                       device="cpu")["layers"][0]["ffn"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert {n: (tuple(w.shape), w.dtype) for n, w in layer.items()} == {
        "router": ((d, e), torch.float32),
        "w_gate": ((e, d, f), torch.bfloat16),
        "w_up": ((e, d, f), torch.bfloat16),
        "w_down": ((e, f, d), torch.bfloat16),
        "norm": ((d,), torch.bfloat16)}


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_unstacks_expert_stacks_bf16(arch):
    """The reference's bf16 pytree (router float32): each layer's expert
    stacks are the reference's ``[rep]`` slice, bitwise, in bf16, and the
    router stays float32."""
    cfg = get_reduced(arch)
    j_params = jax.tree.map(np.asarray, jt.init_lm(jax.random.PRNGKey(0),
                                                   j_get_reduced(arch)))
    layers = params_from_jax(j_params, cfg, device="cpu")["layers"]
    stack = j_params["group"]["pos0"]
    assert len(layers) == cfg.n_layers == stack["ffn"]["w_gate"].shape[0]
    for i, layer in enumerate(layers):
        for part in ("mixer", "ffn"):
            assert sorted(layer[part]) == sorted(stack[part])
            for name, w in layer[part].items():
                want = stack[part][name][i]
                assert w.dtype == (torch.float32 if name == "router"
                                   else torch.bfloat16), name
                np.testing.assert_array_equal(
                    w.float().numpy(), want.astype(np.float32))


# --------------------------------------------------------------------- #
# the model                                                              #
# --------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def model_pair(arch, backend="ref", factor=None):
    """(j_cfg, t_cfg, j_params, t_params) of a reduced float32 MoE model,
    the same weights on both sides; ``factor`` overrides the capacity
    factor.  The reference runs unrolled (``unroll_layers``: the same
    numbers, layers in a Python loop)."""
    kw = {} if factor is None else {"capacity_factor": factor}
    j_cfg = j_get_reduced(arch).replace(dtype="float32", unroll_layers=True,
                                        **kw)
    t_cfg = get_reduced(arch).replace(dtype="float32", attn_backend=backend,
                                      **kw)
    np_params = jax.tree.map(np.asarray,
                             jt.init_lm(jax.random.PRNGKey(0), j_cfg))
    j_params = jax.tree.map(jnp.asarray, np_params)
    return j_cfg, t_cfg, j_params, params_from_jax(np_params, t_cfg,
                                                   device="cpu")


def check_step(t_out, j_out, routes):
    close(t_out.logits, j_out.logits)
    ref = [j_out.caches[f"rem{i}"] for i in range(len(t_out.caches))]
    for tcache, (jk, jv) in zip(t_out.caches, ref, strict=True):
        close(tcache.k, jk)
        close(tcache.v, jv)
    assert len(routes["t"]) == len(routes["j"]) == len(t_out.caches)
    for got, want in zip(routes["t"], routes["j"]):
        np.testing.assert_array_equal(got, want)
    routes["t"].clear()
    routes["j"].clear()


def prefill_then_decode(arch, backend, routes, factor=None, per_row=None):
    """Prefill ``PROMPT_LEN`` tokens, then ``N_DECODE`` decode steps;
    every step's logits, every layer's cache and routed ids must agree.
    ``per_row``: the first step's ``cache_len`` as one length per row.
    Returns the assignments the prefill dropped, summed over layers."""
    j_cfg, t_cfg, j_params, t_params = model_pair(arch, backend, factor)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, t_cfg.vocab, (BATCH, PROMPT_LEN)).astype(
        np.int32)
    steps = rng.integers(0, t_cfg.vocab, (N_DECODE, BATCH, 1)).astype(
        np.int32)
    j_out = jt.lm_apply(j_params, j_cfg, jnp.asarray(prompt), mode="prefill")
    t_out = tt.lm_apply(t_params, t_cfg, torch.as_tensor(prompt,
                                                         dtype=torch.long))
    t = BATCH * PROMPT_LEN
    c = jm.capacity(t, j_cfg.top_k, j_cfg.n_experts, j_cfg.capacity_factor)
    n_dropped = sum(dropped(ids, j_cfg.n_experts, c, t)
                    for ids in routes["j"])
    check_step(t_out, j_out, routes)
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
        check_step(t_out, j_out, routes)
        j_caches, t_caches = j_out.caches, t_out.caches
        if per_row is not None:
            break
    return n_dropped


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, backend, routes):
    prefill_then_decode(arch, backend, routes)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_drops_matches_reference(arch, backend, routes):
    """Capacity factor 0.25: the prefill's 32 tokens (one group) drop
    assignments, and every step still equals the reference's."""
    assert prefill_then_decode(arch, backend, routes, factor=0.25) > 0


@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_with_per_row_cache_len(arch, backend, routes):
    """Step 0 at lengths ``[PROMPT_LEN - 5, PROMPT_LEN]``."""
    prefill_then_decode(arch, backend, routes,
                        per_row=[PROMPT_LEN - 5, PROMPT_LEN])


# --------------------------------------------------------------------- #
# serving                                                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("backend", ["ref", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, backend):
    """Greedy tokens of ``ServeEngine.generate`` equal the reference
    engine's; both feed the whole batch (the rows route together)."""
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


@pytest.mark.parametrize("arch", ARCHS)
def test_fleet_server_two_ticks_match_reference(arch):
    """The fleet server over a reduced MoE model with the kernel
    attention backend (one candidate, power adapts only), profiled with
    fake clocks on both sides, then two ticks of Eq. 4 and Eq. 5 tenants:
    every served input equal (energy rtol 1e-13)."""
    j_cfg, t_cfg, j_params, t_params = model_pair(arch, "kernel")
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
