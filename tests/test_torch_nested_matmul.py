"""The port's ``nested_matmul`` against the JAX package on the CPU.

The plain version (what the wrapper runs on CPU tensors) is held to the
reference's Pallas ``nested_matmul`` run in interpret mode, on the
geometries of ``tests/test_kernels.py`` plus the reduced anytime model's
three projection shapes, at every level with a level-prefix ``x``.

Tolerances: float32 rtol = atol = 1e-5 (both accumulate in float32, in
different orders); bfloat16 one bf16 ulp (both accumulate in float32 and
round once to bfloat16, so a last-place float32 difference can move the
rounding by one ulp, at most 2^-7 of the value), plus an atol of
2^-15 * max|want| for values that cancel towards zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nesting import StripeSpec as JSpec
from repro.core.nesting import nested_linear as j_nested_linear
from repro.kernels.nested_matmul import nested_matmul as j_nested_matmul
from repro.kernels.nested_matmul import nested_matmul_flops as j_flops
from repro.kernels.nested_matmul import tile_limits as j_tile_limits
from repro_torch.core.nesting import StripeSpec as TSpec
from repro_torch.core.nesting import nested_linear as t_nested_linear
from repro_torch.kernels import nested_matmul as nm

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_RTOL = 2.0 ** -7

# (m, k_in, n, levels, bm, bn, bk): tests/test_kernels.py's sweep, then the
# reduced anytime model (d=64, d_ff=128, 3 levels): d->d_ff and d_ff->d
# (its d->d is the sweep's first entry).
GEOMETRIES = [
    (32, 64, 64, 3, 16, 16, 16),
    (64, 128, 256, 4, 32, 32, 16),
    (16, 32, 32, 1, 16, 16, 16),
    (128, 64, 64, 2, 64, 32, 32),
    (32, 64, 128, 3, 16, 16, 16),
    (32, 128, 64, 3, 16, 16, 16),
]
CASES = [pytest.param(g, level, id=f"g{gi}-L{level}")
         for gi, g in enumerate(GEOMETRIES)
         for level in range(1, g[3] + 1)]


def _inputs(m, k_in, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k_in)).astype(np.float32),
            rng.standard_normal((k_in, n)).astype(np.float32))


def _bf16_close(got: np.ndarray, want: np.ndarray) -> None:
    atol = 2.0 ** -15 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol)


@pytest.mark.parametrize("geometry,level", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(geometry, level, dtype):
    m, k_in, n, levels, bm, bn, bk = geometry
    ji, jo = JSpec.pow2(k_in, levels), JSpec.pow2(n, levels)
    ti, to = TSpec.pow2(k_in, levels), TSpec.pow2(n, levels)
    x, w = _inputs(m, k_in, n, seed=level + 10 * k_in + n)
    x = x[:, :ti.width(min(level, levels))]          # level-prefix x
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_nested_matmul(jnp.asarray(x, jd), jnp.asarray(w, jd), ji, jo,
                           level=level, bm=bm, bn=bn, bk=bk,
                           interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = nm.nested_matmul_plain(torch.from_numpy(x).to(td),
                                 torch.from_numpy(w).to(td), ti, to, level)
    assert got.dtype == td and got.shape == (m, to.width(level))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        _bf16_close(got, want)


@pytest.mark.parametrize("k_in,n,levels", [(64, 64, 3), (128, 256, 4),
                                           (768, 3072, 4), (3072, 768, 4),
                                           (64, 64, 1)])
def test_tile_limits_and_flops_equal_reference(k_in, n, levels):
    ji, jo = JSpec.pow2(k_in, levels), JSpec.pow2(n, levels)
    ti, to = TSpec.pow2(k_in, levels), TSpec.pow2(n, levels)
    for level in range(1, levels + 1):
        for m in (1, 4, 32):
            got = nm.nested_matmul_flops(m, ti, to, level)
            assert isinstance(got, int) and got == j_flops(m, ji, jo, level)
        for bn, bk in ((16, 16), (32, 16), (32, 32), (128, 128), (96, 96)):
            try:
                want = j_tile_limits(ji, jo, level, bn, bk)
            except ValueError as exc:
                with pytest.raises(ValueError) as err:
                    nm.tile_limits(ti, to, level, bn, bk)
                assert str(err.value) == str(exc)
                continue
            got = nm.tile_limits(ti, to, level, bn, bk)
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert nm.nested_matmul_flops(3, ti, to) == j_flops(3, ji, jo)


def test_full_width_default_tiles_raise_like_reference():
    """128-wide tiles against 96-wide stripes: the reference's raise at
    ``tile_limits`` that keeps its kernel off the full-width model."""
    ji, ti = JSpec.pow2(768, 4), TSpec.pow2(768, 4)
    with pytest.raises(ValueError, match="spans an output stripe"):
        j_tile_limits(ji, ji, 4, 128, 128)
    with pytest.raises(ValueError, match="spans an output stripe"):
        nm.tile_limits(ti, ti, 4, 128, 128)


def test_cost_counts_live_blocks():
    spec = TSpec.pow2(768, 4)
    c = nm.nested_matmul_cost(32, spec, spec, 4, torch.bfloat16)
    live = 96 * 96 + 192 * 96 + 384 * 192 + 768 * 384
    assert c["live_weight_elements"] == live
    assert live / 768 ** 2 == pytest.approx(0.671875)
    assert c["flops"] == 2 * 32 * live
    assert c["bytes_accessed"] == 2 * (32 * 768 + live + 32 * 768)
    c1 = nm.nested_matmul_cost(4, spec, spec, 1, torch.float32)
    assert c1["bytes_accessed"] == 4 * (4 * 96 + 96 * 96 + 4 * 96)


@pytest.mark.parametrize("level", [1, 2, 3, None])
@pytest.mark.parametrize("shape", [("d", "d"), ("d", "f"), ("f", "d")])
def test_nested_linear_kernel_backend_3d(level, shape):
    """``backend="kernel"`` on a ``[B, S, d]`` input equals the port's and
    the reference's ``blocks`` backend (the reference's own kernel
    backend cannot take 3-D input)."""
    widths = {"d": 64, "f": 128}
    k_in, n = widths[shape[0]], widths[shape[1]]
    ti, to = TSpec.pow2(k_in, 3), TSpec.pow2(n, 3)
    ji, jo = JSpec.pow2(k_in, 3), JSpec.pow2(n, 3)
    rng = np.random.default_rng(k_in + n)
    x = rng.standard_normal((2, 5, k_in)).astype(np.float32)
    w = rng.standard_normal((k_in, n)).astype(np.float32)
    if level is not None:
        x = x[..., :ti.width(level)]
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = t_nested_linear(xt, wt, ti, to, level, backend="kernel")
    blocks = t_nested_linear(xt, wt, ti, to, level, backend="blocks")
    want = j_nested_linear(jnp.asarray(x), jnp.asarray(w), ji, jo, level,
                           backend="blocks")
    assert got.shape == blocks.shape == (2, 5, to.width(level or 3))
    np.testing.assert_allclose(got.numpy(), blocks.numpy(), **F32_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_cpu_wrapper_runs_plain_and_counts_nothing():
    spec = TSpec.pow2(64, 3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    before = nm.nested_matmul.launches
    before_v4 = nm.nested_matmul.v4_launches
    for level in (1, 2, 3, None):
        got = nm.nested_matmul(x, w, spec, spec, level)
        assert torch.equal(got, nm.nested_matmul_plain(x, w, spec, spec,
                                                       level))
    assert nm.nested_matmul.launches == before
    assert nm.nested_matmul.v4_launches == before_v4
    with pytest.raises(ValueError, match="CUDA or CPU"):
        nm.nested_matmul(x.to("meta"), w.to("meta"), spec, spec)


@pytest.mark.parametrize("m", [1, 4, 16, 17, 32, 33])
def test_split_plan_from_shapes(m):
    """The v3 launch plan at the anytime LM's three geometries and every
    level, on 132 SMs: 16- or 32-row tiles covering M, 64-column tiles
    covering the level's outputs, between 1 and 16 splits and no more
    than the 64-row steps of the longest k range (2/3 of them once the
    grid is not small), and at level 4
    the d->d_ff and d_ff->d launches at least 1.45 blocks per SM."""
    d, f = TSpec.pow2(768, 4), TSpec.pow2(3072, 4)
    for name, si, so in (("d->d", d, d), ("d->d_ff", d, f),
                         ("d_ff->d", f, d)):
        for level in range(1, 5):
            k_end = si.width(min(level, si.levels))
            splits, m_tiles, n_tiles = nm.nested_split_plan(
                m, so.width(level), k_end, 132)
            bm = 16 if m <= 16 else 32
            assert (m_tiles - 1) * bm < m <= m_tiles * bm
            assert (n_tiles - 1) * nm.TILE_N < so.width(level) <= \
                n_tiles * nm.TILE_N
            steps = -(-k_end // nm.STEP_K)
            assert 1 <= splits <= min(nm.MAX_SPLITS, steps)
            if m_tiles * n_tiles * steps > 132 // 4:
                assert splits <= -(-2 * steps // 3)
            if level == 4 and name != "d->d" and m <= 32:
                assert splits * m_tiles * n_tiles >= 1.45 * 132, name


# --------------------------------------------------------------------- #
# v4: the path from the shapes, and its launch plan                      #
# --------------------------------------------------------------------- #
# (k_in, n) of Mistral-7B-v0.3's projections, nested in 4 power-of-2
# levels: the benchmark's scoring prefill runs them at M = 512.
MISTRAL = {"d->q": (4096, 4096), "d->kv": (4096, 1024),
           "d->d_ff": (4096, 14336), "d_ff->d": (14336, 4096)}
# Stripes that are no multiple of 64 or of the 128-column tile, over
# input prefixes that are none of the 64-row step.
# An H100 SXM's SMs.
H100_SLOTS = 132
ODD = (TSpec((0, 40, 100, 200, 328)), TSpec((0, 24, 72, 176, 264)))


def _specs(geometry):
    if geometry == "odd":
        return ODD
    k_in, n = MISTRAL[geometry]
    return TSpec.pow2(k_in, 4), TSpec.pow2(n, 4)


def _operands(m, si, so, level, dtype=torch.bfloat16):
    """A call's operands on the meta device (shapes, strides and offsets
    without storage): a level-prefix view of a full-width x, the full w."""
    x = torch.empty(m, si.total, dtype=dtype, device="meta")
    w = torch.empty(si.total, so.total, dtype=dtype, device="meta")
    return x[:, :si.width(min(level, si.levels))], w


@pytest.mark.parametrize("m", [1, 4, 8, 16, 32])
def test_served_shapes_stay_on_v3(m):
    """The anytime LM's decode (M = 4) and served prefill (B=4 x S=8)
    shapes, at its three geometries and every level, take v3."""
    d, f = TSpec.pow2(768, 4), TSpec.pow2(3072, 4)
    for si, so in ((d, d), (d, f), (f, d)):
        for level in range(1, 5):
            assert nm.nested_path(*_operands(m, si, so, level)) == "v3"


@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("geometry", list(MISTRAL))
def test_scoring_shapes_take_v4(geometry, level):
    """Mistral-7B's projections at M = 512 take v4 at every level, and
    from ``WIDE_MIN_M`` rows on; float32, or a row that starts off a
    16-byte boundary, takes v2."""
    si, so = _specs(geometry)
    assert nm.nested_path(*_operands(512, si, so, level)) == "v4"
    assert nm.nested_path(*_operands(nm.WIDE_MIN_M, si, so, level)) == "v4"
    assert nm.nested_path(*_operands(nm.WIDE_MIN_M - 1, si, so,
                                     level)) == "v3"
    assert nm.nested_path(*_operands(512, si, so, level,
                                     torch.float32)) == "v2"
    x, w = _operands(512, si, so, level)
    assert nm.nested_path(x[:, 4:], w) == "v2"
    assert nm.nested_path(x, w[:, 4:]) == "v2"


def _column_limit(si, so, c):
    """The input prefix read by output column ``c`` (its stripe's)."""
    stripe = next(i for i in range(1, so.levels + 1) if c < so.width(i))
    return si.width(min(stripe, si.levels))


def _units(plan, tile_limits):
    """The blocks of a v4 launch in launch order, as the kernel reads the
    plan's runs: ``(row tile, column tile, chunk, splits, k_lo, k_hi)``
    with ``[k_lo, k_hi)`` the chunk's rows of the weight; None for a pad
    block."""
    units = []
    for t0, tiles, splits, _ in plan.runs:
        for t in range(tiles * plan.m_tiles):
            col = t0 + t // plan.m_tiles
            steps = -(-tile_limits[col] // nm.WIDE_STEP_K)
            for c in range(splits):
                lo, hi = c * steps // splits, (c + 1) * steps // splits
                units.append((t % plan.m_tiles, col, c, splits,
                              lo * nm.WIDE_STEP_K,
                              min(hi * nm.WIDE_STEP_K, tile_limits[col])))
    return units + [None] * (plan.blocks - len(units))


@pytest.mark.parametrize("m", [128, 512, 520])
@pytest.mark.parametrize("geometry", list(MISTRAL) + ["odd"])
def test_wide_plan_covers_each_column_once(geometry, m):
    """At every level the plan's blocks cover each (row tile, column tile)
    once, its chunks' k ranges tiling [0, the tile's limit) in order, the
    limit that of the tile's last column and no column reading further;
    row tiles cover M; a split tile's chunks share one cluster."""
    si, so = _specs(geometry)
    for level in range(1, so.levels + 1):
        n_cols = so.width(level)
        lims = nm.wide_tile_limits(tuple(si.boundaries),
                                   tuple(so.boundaries), level)
        n_tiles = -(-n_cols // nm.WIDE_TILE_N)
        assert len(lims) == n_tiles
        for t, lim in enumerate(lims):
            cols = range(t * nm.WIDE_TILE_N,
                         min((t + 1) * nm.WIDE_TILE_N, n_cols))
            assert lim == _column_limit(si, so, cols[-1])
            assert all(_column_limit(si, so, c) <= lim for c in cols)
        plan = nm.nested_wide_plan(m, lims, H100_SLOTS)
        assert plan.bm in (128, 256)
        assert (plan.m_tiles - 1) * plan.bm < m <= plan.m_tiles * plan.bm
        assert plan.cluster in nm.WIDE_CLUSTERS
        assert plan.cluster == max(s for _, _, s, _ in plan.runs)
        assert plan.blocks % plan.cluster == 0
        units = _units(plan, lims)
        assert len(units) == plan.blocks
        live = [u for u in units if u is not None]
        assert all(u is None for u in units[len(live):])
        seen = {}
        for i, (row, col, chunk, splits, lo, hi) in enumerate(live):
            assert splits in nm.WIDE_CLUSTERS and splits <= plan.cluster
            assert (i - chunk) // plan.cluster == i // plan.cluster
            seen.setdefault((row, col), []).append((chunk, lo, hi))
        assert set(seen) == {(r, c) for r in range(plan.m_tiles)
                             for c in range(n_tiles)}
        for (row, col), chunks in seen.items():
            assert [c for c, _, _ in chunks] == list(range(len(chunks)))
            bounds = [b for _, lo, hi in chunks for b in (lo, hi)]
            assert bounds[0] == 0 and bounds[-1] == lims[col]
            assert all(lo < hi for _, lo, hi in chunks)
            assert bounds[1:-1:2] == bounds[2::2]


@pytest.mark.parametrize("m", [128, 512])
@pytest.mark.parametrize("geometry", list(MISTRAL) + ["odd"])
def test_wide_plan_runs_longest_k_first(geometry, m):
    """The launch order walks the column tiles longest k first, and the
    split of a run never grows along it (so a tile's chunks never
    straddle a cluster)."""
    si, so = _specs(geometry)
    for level in range(1, so.levels + 1):
        lims = nm.wide_tile_limits(tuple(si.boundaries),
                                   tuple(so.boundaries), level)
        plan = nm.nested_wide_plan(m, lims, H100_SLOTS)
        live = [u for u in _units(plan, lims) if u is not None]
        order = [lims[col] for _, col, _, _, _, _ in live]
        assert order == sorted(order, reverse=True)
        splits = [s for _, _, s, _ in plan.runs]
        assert splits == sorted(splits, reverse=True)
        assert [u0 for _, _, _, u0 in plan.runs] == [
            sum(t * plan.m_tiles * s for _, t, s, _ in plan.runs[:g])
            for g in range(len(plan.runs))]


def test_wide_plan_splits_the_wide_stripe():
    """At d_ff->d level 4 (k 1792 .. 14336, 64 tiles of 256 x 128 on 132
    SMs) the plan splits the last stripe's tiles in k, and models that as
    faster than the best launch without a split."""
    si, so = _specs("d_ff->d")
    lims = nm.wide_tile_limits(tuple(si.boundaries), tuple(so.boundaries),
                               4)
    plan = nm.nested_wide_plan(512, lims, H100_SLOTS)
    assert plan.runs[0][2] > 1
    unsplit = [p for p in nm.wide_candidates(512, lims, H100_SLOTS)
               if p.cluster == 1]
    assert unsplit and plan.makespan < min(p.makespan for p in unsplit)
