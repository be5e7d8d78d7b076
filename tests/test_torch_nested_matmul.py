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
    for level in (1, 2, 3, None):
        got = nm.nested_matmul(x, w, spec, spec, level)
        assert torch.equal(got, nm.nested_matmul_plain(x, w, spec, spec,
                                                       level))
    assert nm.nested_matmul.launches == before
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
