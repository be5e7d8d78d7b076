"""The port's checkpoint I/O, single-device elastic helpers, failure
injection, straggler monitor and bank paging (``repro_torch.checkpoint``,
``repro_torch.runtime``, the lane banks' ``export_lanes`` /
``import_lanes`` / ``shrink`` / ``grow``) against the reference on the
CPU.

The two packages write the same checkpoint layout (leaf names in
``jax.tree_util``'s order, ``/``-joined paths), so each reads the other's.
Unlike the reference, the port restores a float64 leaf as float64.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.core import batched as jb
from repro.core import kalman as jk
from repro.runtime import elastic as je
from repro.runtime import straggler as jst
from repro_torch.checkpoint import io as tio
from repro_torch.core import batched as tb
from repro_torch.core import kalman as tk
from repro_torch.runtime import elastic as te
from repro_torch.runtime import ft
from repro_torch.runtime import straggler as tst
from tests._hypothesis_compat import given, settings, st

CPU = torch.device("cpu")
SLOW = ("mu", "sigma", "gain", "process_noise", "n_updates")
IDLE = ("phi", "variance", "n_updates")
GOAL = ("goal", "buf", "count", "pos")


def mixed_tree():
    return {"a": {"b": np.arange(6, dtype=np.int64),
                  "c": np.linspace(0, 1, 5)},
            "d": np.array([True, False, True]),
            "e": np.float32(3.25),
            "f": np.zeros((0, 4)),
            "g": [np.int64(7), (np.full(2, 0.5, np.float32), None)],
            "z": torch.arange(4, dtype=torch.float64) / 3}


def as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------- #
# checkpoint/io.py                                                       #
# --------------------------------------------------------------------- #
def test_roundtrip_nested_mixed_dtypes(tmp_path):
    tree = mixed_tree()
    d = str(tmp_path / "ck")
    tio.save(d, tree, step=7, extra={"tag": "x"})
    got, step = tio.restore(d, tree)
    assert step == 7
    pairs = [(got["a"]["b"], tree["a"]["b"]), (got["a"]["c"], tree["a"]["c"]),
             (got["d"], tree["d"]), (got["e"], tree["e"]),
             (got["f"], tree["f"]), (got["g"][0], tree["g"][0]),
             (got["g"][1][0], tree["g"][1][0]), (got["z"], tree["z"])]
    for a, b in pairs:
        assert isinstance(a, torch.Tensor) and a.device == CPU
        np.testing.assert_array_equal(a.numpy(), as_numpy(b))
        assert a.numpy().dtype == as_numpy(b).dtype
    assert isinstance(got["g"], list) and isinstance(got["g"][1], tuple)
    assert got["g"][1][1] is None
    assert tio.load_manifest(d)["extra"] == {"tag": "x"}
    assert tio.latest_step(d) == 7


def test_leaf_order_is_jax_tree_util_order(tmp_path):
    """Dict keys sorted, sequence items by index, None an empty subtree:
    the port and the reference write identical manifests and arrays."""
    tree = {"zeta": np.ones(2), "alpha": {"y": np.arange(3), "b": [
        np.float64(1.5), None, np.zeros((2, 2), np.float32)]},
        "mid": (np.array([True]),), "10": np.int64(4), "9": np.int64(5)}
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jio.save(jd, tree, step=3)
    tio.save(td, tree, step=3)
    assert tio.load_manifest(td) == jio.load_manifest(jd)
    with np.load(os.path.join(jd, "arrays.npz")) as a, \
            np.load(os.path.join(td, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], b[name])
            assert a[name].dtype == b[name].dtype


def test_cross_package_trees(tmp_path):
    """A tree the reference saves reads back in the port unchanged,
    float64 included, through ``restore_tree`` and ``restore``; a tree
    the port saves (tensor leaves among them) reads back in the
    reference's ``restore_tree``."""
    tree = {"meta": {"x": np.int64(3), "t": np.float64(0.1)},
            "bank": {"mu": np.linspace(1, 2, 4), "n": np.arange(4)},
            "flags": np.array([True, False])}
    d = str(tmp_path / "ref")
    jio.save(d, tree, step=2)
    raw, step = tio.restore_tree(d)
    assert step == 2
    got, _ = tio.restore(d, tree)
    for part, key in (("meta", "x"), ("meta", "t"), ("bank", "mu"),
                      ("bank", "n")):
        want = np.asarray(tree[part][key])
        np.testing.assert_array_equal(raw[part][key], want)
        assert raw[part][key].dtype == want.dtype
        assert got[part][key].numpy().dtype == want.dtype
        np.testing.assert_array_equal(got[part][key].numpy(), want)
    assert got["bank"]["mu"].dtype == torch.float64
    ptree = {"bank": {"mu": torch.linspace(1, 2, 4, dtype=torch.float64),
                      "n": torch.arange(4)}, "x": np.float32(2.5)}
    d = str(tmp_path / "port")
    tio.save(d, ptree, step=9)
    raw, step = jio.restore_tree(d)
    assert step == 9
    np.testing.assert_array_equal(raw["bank"]["mu"],
                                  ptree["bank"]["mu"].numpy())
    assert raw["bank"]["mu"].dtype == np.float64
    assert raw["bank"]["n"].dtype == np.int64 and raw["x"] == 2.5


def bf16_bits() -> torch.Tensor:
    """bfloat16 values that a cast would disturb: signed zeros, a
    subnormal, the largest finite, infinities and a NaN with a payload."""
    bits = np.array([0x0000, 0x8000, 0x0001, 0x7F7F, 0xFF7F, 0x7F80, 0xFF80,
                     0x7FC1, 0x3FC0, 0xBE20], dtype=np.uint16)
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def bits_of(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_train_state_roundtrip_bitwise(tmp_path):
    """A train state (NamedTuples) with bf16 params and float32 moments
    comes back as its own types, every bit equal, and the manifest names
    the bf16 leaves "bfloat16" (the reference's ``str(arr.dtype)``)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16),
              "layers": [{"norm": bf16_bits()}]}
    moments = lambda: {"w": torch.randn(3, 4, generator=g),
                       "layers": [{"norm": torch.randn(10, generator=g)}]}
    state = TrainState(params, AdamWState(torch.tensor(7, dtype=torch.int32),
                                          moments(), moments()), None)
    d = str(tmp_path / "ck")
    tio.save(d, state, step=7)
    like = TrainState(
        {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
         "layers": [{"norm": torch.zeros(10, dtype=torch.bfloat16)}]},
        AdamWState(torch.zeros((), dtype=torch.int32), moments(),
                   moments()), None)
    got, step = tio.restore(d, like)
    assert step == 7 and type(got) is TrainState
    assert type(got.opt_state) is AdamWState and got.compress_state is None
    assert got.params["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits_of(got.params["w"]),
                                  bits_of(params["w"]))
    np.testing.assert_array_equal(bits_of(got.params["layers"][0]["norm"]),
                                  bits_of(bf16_bits()))
    for a, b in ((got.opt_state.m, state.opt_state.m),
                 (got.opt_state.v, state.opt_state.v)):
        assert torch.equal(a["w"], b["w"]) and a["w"].dtype == torch.float32
    assert int(got.opt_state.step) == 7
    recs = {r["path"]: r for r in tio.load_manifest(d)["leaves"]}
    assert recs[".params/w"]["dtype"] == "bfloat16"
    assert recs[".opt_state/.m/w"]["dtype"] == "float32"
    assert ".opt_state/.step" in recs


def test_namedtuple_paths_are_the_references(tmp_path):
    """The reference names a NamedTuple's fields ``.<field>`` (jax's
    attribute keys): both packages write one manifest for one state."""
    import jax.numpy as jnp

    from repro.optim.adamw import AdamWState as JState
    from repro.train.step import TrainState as JTrain
    from repro_torch.optim.adamw import AdamWState as TState
    from repro_torch.train.step import TrainState as TTrain

    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    jtree = JTrain({"w": jnp.asarray(w), "b": [jnp.ones(2)]},
                   JState(jnp.asarray(3, jnp.int32), {"w": jnp.zeros((2, 3)),
                          "b": [jnp.zeros(2)]}, {"w": jnp.zeros((2, 3)),
                                                 "b": [jnp.zeros(2)]}), None)
    ttree = TTrain({"w": torch.from_numpy(w), "b": [torch.ones(2)]},
                   TState(torch.tensor(3, dtype=torch.int32),
                          {"w": torch.zeros(2, 3), "b": [torch.zeros(2)]},
                          {"w": torch.zeros(2, 3), "b": [torch.zeros(2)]}),
                   None)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jio.save(jd, jtree, step=3)
    tio.save(td, ttree, step=3)
    assert tio.load_manifest(td) == jio.load_manifest(jd)
    got, _ = tio.restore(jd, ttree)
    assert type(got) is TTrain and torch.equal(got.params["w"],
                                               torch.from_numpy(w))


def test_bf16_saved_by_the_reference_restores_bitwise(tmp_path):
    import jax.numpy as jnp
    import ml_dtypes

    raw = bits_of(bf16_bits())
    tree = {"w": jnp.asarray(raw.view(ml_dtypes.bfloat16)),
            "m": jnp.linspace(0, 1, 10)}
    d = str(tmp_path / "ref")
    jio.save(d, tree, step=1)
    like = {"w": torch.zeros(10, dtype=torch.bfloat16),
            "m": torch.zeros(10)}
    got, _ = tio.restore(d, like)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(bits_of(got["w"]), raw)
    raw_tree, _ = tio.restore_tree(d)
    np.testing.assert_array_equal(raw_tree["w"].view(np.uint16), raw)


def test_bf16_saved_by_the_port_holds_the_references_bytes(tmp_path):
    """The port writes a bf16 leaf as the reference does (its bits as
    numpy's ``V2``, "bfloat16" in the manifest): the two packages' files
    are equal, and the reference's reader gives back the bits exactly.
    Its ``restore``, though, cannot cast ``V2`` to bfloat16 and refuses
    either package's bf16 checkpoint (a reference-side gap; a plain
    uint16 array would instead be cast by value, silently wrong)."""
    import jax.numpy as jnp
    import ml_dtypes

    raw = bits_of(bf16_bits())
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jio.save(jd, {"w": jnp.asarray(raw.view(ml_dtypes.bfloat16))}, step=4)
    tio.save(td, {"w": bf16_bits()}, step=4)
    assert tio.load_manifest(td) == jio.load_manifest(jd)
    assert tio.load_manifest(td)["leaves"][0]["dtype"] == "bfloat16"
    with np.load(os.path.join(jd, "arrays.npz")) as a, \
            np.load(os.path.join(td, "arrays.npz")) as b:
        assert a["leaf_0"].dtype == b["leaf_0"].dtype == np.dtype("V2")
        assert a["leaf_0"].tobytes() == b["leaf_0"].tobytes()
    got, _ = jio.restore_tree(td)
    np.testing.assert_array_equal(
        got["w"].view(ml_dtypes.bfloat16).view(np.uint16), raw)
    like = {"w": jnp.zeros(10, jnp.bfloat16)}
    for d in (jd, td):
        with pytest.raises(ValueError, match="No cast function"):
            jio.restore(d, like)
    # an ml_dtypes leaf given to the port is written the same way
    tio.save(td, {"w": raw.view(ml_dtypes.bfloat16)}, step=4)
    with np.load(os.path.join(td, "arrays.npz")) as b:
        assert b["leaf_0"].tobytes() == raw.tobytes()


def test_restore_onto_tensors_keeps_their_dtype(tmp_path):
    d = str(tmp_path / "ck")
    tio.save(d, {"w": np.arange(4, dtype=np.float64),
                 "i": np.arange(3, dtype=np.int64)}, step=1)
    like = {"w": torch.zeros(4, dtype=torch.float32),
            "i": torch.zeros(3, dtype=torch.int32)}
    got, _ = tio.restore(d, like)
    assert got["w"].dtype == torch.float32 and got["i"].dtype == torch.int32
    np.testing.assert_array_equal(got["w"].numpy(), np.arange(4))
    with pytest.raises(ValueError, match="checkpoint shape"):
        tio.restore(d, {"w": torch.zeros(5), "i": torch.zeros(3)})
    with pytest.raises(KeyError, match="missing leaf 'v'"):
        tio.restore(d, {"v": np.zeros(4)})


def test_restore_tree_rebuilds_without_like(tmp_path):
    tree = {"meta": {"x": np.int64(3)}, "bank": {"mu": np.linspace(1, 2, 4)}}
    d = str(tmp_path / "ck")
    tio.save(d, tree, step=2)
    got, step = tio.restore_tree(d)
    assert step == 2 and got["meta"]["x"] == 3
    np.testing.assert_array_equal(got["bank"]["mu"], tree["bank"]["mu"])


def test_empty_tree_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    tio.save(d, {}, step=1)
    assert tio.restore_tree(d) == ({}, 1)
    assert tio.restore(d, {}) == ({}, 1)


def test_latest_step_none_when_missing(tmp_path):
    assert tio.latest_step(str(tmp_path / "nope")) is None


def test_overwrite_leaves_no_debris(tmp_path):
    d = str(tmp_path / "ck")
    tio.save(d, {"w": np.zeros(2)}, step=1)
    tio.save(d, {"w": np.ones(2)}, step=2)
    assert tio.latest_step(d) == 2
    assert not os.path.exists(d + ".tmp")
    assert not os.path.exists(d + ".old")
    got, _ = tio.restore(d, {"w": np.zeros(2)})
    np.testing.assert_array_equal(got["w"].numpy(), np.ones(2))


def test_torn_write_falls_back_to_old(tmp_path):
    """A crash between parking the live checkpoint at ``.old`` and
    promoting the new one leaves the old one findable, and the next save
    recovers."""
    d = str(tmp_path / "ck")
    tio.save(d, {"w": np.full(2, 5.0)}, step=5)
    os.replace(d, d + ".old")
    assert tio.latest_step(d) == 5
    got, step = tio.restore(d, {"w": np.zeros(2)})
    assert step == 5
    np.testing.assert_array_equal(got["w"].numpy(), np.full(2, 5.0))
    raw, _ = tio.restore_tree(d)
    np.testing.assert_array_equal(raw["w"], np.full(2, 5.0))
    # a stale .tmp from an earlier crash is replaced, not promoted
    os.makedirs(d + ".tmp")
    tio.save(d, {"w": np.full(2, 6.0)}, step=6)
    assert tio.latest_step(d) == 6
    assert not os.path.exists(d + ".old")
    assert not os.path.exists(d + ".tmp")


@settings(max_examples=25, deadline=None)
@given(vals=st.lists(st.floats(allow_nan=False, allow_infinity=False,
                               width=64), min_size=0, max_size=12),
       dtype=st.sampled_from(["float64", "float32", "int64", "bool"]),
       step=st.integers(0, 10 ** 9),
       nest=st.booleans())
def test_roundtrip_property(vals, dtype, step, nest):
    """Save and restore are the identity on any tree of arrays: every
    dtype (float64 restored as float64, which the reference's restore
    does not do), any length including 0, any nesting, any step, and
    ``restore_tree`` agrees with ``restore``."""
    arr = np.asarray(vals, dtype=np.float64).astype(dtype)
    tree = {"x": {"y": arr}} if nest else {"x": arr}
    with tempfile.TemporaryDirectory() as td:
        d = os.path.join(td, "ck")
        tio.save(d, tree, step=step)
        got, s1 = tio.restore(d, tree)
        raw, s2 = tio.restore_tree(d)
        assert s1 == s2 == step
        leaf = got["x"]["y"] if nest else got["x"]
        rleaf = raw["x"]["y"] if nest else raw["x"]
        np.testing.assert_array_equal(leaf.numpy(), arr)
        assert leaf.numpy().dtype == arr.dtype
        np.testing.assert_array_equal(rleaf, arr)
        assert rleaf.dtype == arr.dtype


# --------------------------------------------------------------------- #
# runtime/                                                               #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("n_lanes,n_devices,lost", [
    (8, 4, [3]), (256, 4, [3]), (12, 3, [0, 2]), (16, 16, []), (6, 1, [0])])
def test_lane_groups_and_dead_mask(n_lanes, n_devices, lost):
    np.testing.assert_array_equal(te.lane_groups(n_lanes, n_devices),
                                  je.lane_groups(n_lanes, n_devices))
    got = te.dead_lane_mask(n_lanes, n_devices, lost)
    np.testing.assert_array_equal(
        got, je.dead_lane_mask(n_lanes, n_devices, lost))
    assert int(got.sum()) == len(lost) * n_lanes // n_devices
    assert te.surviving_lane_capacity(n_lanes, n_devices, len(lost)) == \
        je.surviving_lane_capacity(n_lanes, n_devices, len(lost)) == \
        n_lanes - int(got.sum())


def test_lane_groups_need_divisible_counts():
    with pytest.raises(ValueError, match="not divisible"):
        te.lane_groups(10, 4)


@pytest.mark.parametrize("n,tp", [(256, 8), (240, 8), (7, 4), (12, 16),
                                  (1, 1)])
def test_best_mesh_shape(n, tp):
    assert te.best_mesh_shape(n, tp) == je.best_mesh_shape(n, tp)


def test_injected_failure_is_a_runtime_error():
    with pytest.raises(RuntimeError, match="crash"):
        raise ft.InjectedFailure("simulated crash")


def test_scalar_kalman_bitwise():
    rng = np.random.default_rng(1)
    got, want = tk.ScalarKalman(), jk.ScalarKalman()
    for v in rng.uniform(0.5, 3.0, 200):
        assert got.observe(float(v)) == want.observe(float(v))
        assert got.std == want.std and got.variance == want.variance


def test_straggler_monitor_equals_reference():
    """A host running 3x slow flags within a handful of steps and
    escalates to "reshard"; flags and recommendations equal the
    reference's step by step, noise included."""
    rng = np.random.default_rng(4)
    got, want = tst.StragglerMonitor(4, persistent_after=3), \
        jst.StragglerMonitor(4, persistent_after=3)
    first = None
    for k in range(30):
        times = list(rng.normal(1.0, 0.02, 4))
        if k >= 5:
            times[2] = 3.0
        flagged = got.observe(times)
        assert flagged == want.observe(times)
        assert [got.recommendation(h) for h in range(4)] == \
            [want.recommendation(h) for h in range(4)]
        if flagged and first is None:
            first = k
            assert flagged == [2]
    assert first is not None and first <= 10
    assert got.recommendation(2) == "reshard"
    assert all(got.recommendation(h) == "tolerate" for h in (0, 1, 3))


# --------------------------------------------------------------------- #
# Bank paging                                                            #
# --------------------------------------------------------------------- #
def scrambled_banks(mod_k, mod_b, s=8, ticks=5, seed=0, **kw):
    """Both filter banks and a goal bank after ``ticks`` random masked
    feedback steps (the reference's ``_scrambled_banks``)."""
    rng = np.random.default_rng(seed)
    slow = mod_k.SlowdownFilterBank(s, **kw)
    idle = mod_k.IdlePowerFilterBank(s, **kw)
    goal = mod_b.WindowedGoalBank(rng.uniform(0.5, 0.9, s), s, window=4,
                                  **kw)
    for _ in range(ticks):
        mask = rng.random(s) < 0.8
        mod_k.observe_fleet(slow, idle, rng.uniform(0.5, 2.0, s),
                            rng.uniform(0.5, 2.0, s),
                            deadline_missed=rng.random(s) < 0.2,
                            idle_power=rng.uniform(0.1, 0.5, s),
                            active_power=rng.uniform(0.5, 1.5, s),
                            mask=mask)
        goal.record(rng.uniform(0.4, 1.0, s), mask=mask)
    return slow, idle, goal


def port_banks(**kw):
    return scrambled_banks(tk, tb, device=CPU, **kw)


def test_export_import_round_trip_bitwise():
    """export -> another tenant resets and scrambles the lanes -> import
    restores every state vector of the three banks bit for bit."""
    banks = port_banks()
    lanes = [1, 3, 6]
    snap = [b.export_lanes(lanes) for b in banks]
    before = [b.export_lanes(np.arange(8)) for b in banks]
    slow, idle, goal = banks
    slow.reset_lanes(lanes)
    idle.reset_lanes(lanes)
    goal.reset_lanes(lanes, goal=[0.1, 0.2, 0.3])
    tk.observe_fleet(slow, idle, np.full(8, 1.7), np.ones(8),
                     idle_power=np.full(8, 0.3), active_power=np.ones(8))
    goal.record(np.full(8, 0.5))
    for b, sn in zip(banks, snap):
        b.import_lanes(lanes, sn)
    for b, want, names in zip(banks, before, (SLOW, IDLE, GOAL)):
        got = b.export_lanes(np.arange(8))
        assert tuple(got) == names
        for n in names:
            np.testing.assert_array_equal(got[n][lanes], want[n][lanes],
                                          err_msg=n)
            assert got[n].dtype == want[n].dtype


def test_import_does_not_touch_other_lanes():
    banks = port_banks(seed=3)
    others = [0, 2, 4, 5, 7]
    for b in banks:
        keep = b.export_lanes(others)
        b.import_lanes([3], b.export_lanes([1]))
        got = b.export_lanes(others)
        for n in keep:
            np.testing.assert_array_equal(got[n], keep[n], err_msg=n)
        assert all(np.array_equal(b.export_lanes([1])[n],
                                  b.export_lanes([3])[n]) for n in keep)


def test_export_returns_host_copies():
    slow = port_banks()[0]
    snap = slow.export_lanes([0, 1])
    assert all(isinstance(v, np.ndarray) for v in snap.values())
    mu = snap["mu"].copy()
    slow.reset_lanes([0, 1])
    np.testing.assert_array_equal(snap["mu"], mu)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("ticks", [5, 40])
def test_export_matches_reference(seed, ticks):
    """After the same feedback sequence the port's snapshot has the
    reference's keys, dtypes and shapes, the goal bank's and the update
    counts bit for bit.  The filter floats agree to a few ulp: the
    reference's XLA Kalman step may contract a multiply-add where the
    port rounds twice (ROADMAP queue C), and the filters damp the
    difference."""
    lanes = [1, 3, 6]
    for got_bank, want_bank in zip(port_banks(seed=seed, ticks=ticks),
                                   scrambled_banks(jk, jb, seed=seed,
                                                   ticks=ticks)):
        got, want = got_bank.export_lanes(lanes), \
            want_bank.export_lanes(lanes)
        assert tuple(got) == tuple(want)
        for n in got:
            assert got[n].dtype == want[n].dtype, n
            assert got[n].shape == want[n].shape, n
            if got[n].dtype.kind != "f" or isinstance(
                    got_bank, tb.WindowedGoalBank):
                np.testing.assert_array_equal(got[n], want[n], err_msg=n)
            else:
                np.testing.assert_array_max_ulp(got[n], want[n], maxulp=16)


def test_reference_snapshot_imports_bitwise():
    """A snapshot the reference exported imports into the port's banks
    bit for bit (the gateway's paged-session store carries over)."""
    lanes = [0, 5]
    for got_bank, want_bank in zip(port_banks(seed=2),
                                   scrambled_banks(jk, jb, seed=2)):
        snap = want_bank.export_lanes(lanes)
        got_bank.import_lanes([2, 7], snap)
        got = got_bank.export_lanes([2, 7])
        for n in snap:
            np.testing.assert_array_equal(got[n], snap[n], err_msg=n)
            assert got[n].dtype == snap[n].dtype


@pytest.mark.parametrize("new", [3, 8, 11])
def test_shrink_and_grow(new):
    """``shrink`` keeps the first lanes bitwise, ``grow`` adds fresh
    priors and, for the goal bank, ``goal_fill``: as the reference."""
    for got_bank, want_bank in zip(port_banks(), scrambled_banks(jk, jb)):
        if isinstance(got_bank, tb.WindowedGoalBank):
            keep = got_bank.export_lanes(np.arange(8))
            got_bank.grow(new, goal_fill=0.6)
            want_bank.grow(new, goal_fill=0.6)
            assert got_bank.goal.shape[0] == max(new, 8)
            got = got_bank.export_lanes(np.arange(max(new, 8)))
            want = want_bank.export_lanes(np.arange(max(new, 8)))
            for n in got:
                np.testing.assert_array_equal(got[n], want[n], err_msg=n)
                np.testing.assert_array_equal(got[n][:8], keep[n])
            np.testing.assert_array_equal(
                got_bank.current_goal().numpy()[8:],
                np.full(max(new, 8) - 8, 0.6))
            continue
        keep = got_bank.export_lanes(np.arange(8))
        got_bank.shrink(new)
        want_bank.shrink(new)
        assert got_bank.n_streams == want_bank.n_streams == min(new, 8)
        got = got_bank.export_lanes(np.arange(got_bank.n_streams))
        for n in got:
            np.testing.assert_array_equal(got[n], keep[n][:min(new, 8)])
        got_bank.grow(12)
        want_bank.grow(12)
        got = got_bank.export_lanes(np.arange(min(new, 8), 12))
        want = want_bank.export_lanes(np.arange(min(new, 8), 12))
        for n in got:
            np.testing.assert_array_equal(got[n], want[n], err_msg=n)


def test_goal_bank_grow_default_fill_is_zero():
    bank = tb.WindowedGoalBank(0.8, 2, device=CPU)
    bank.grow(4)
    np.testing.assert_array_equal(bank.goal.numpy(), [0.8, 0.8, 0.0, 0.0])
