"""``rwkv_scan`` v3's sequence split on the CPU.

* ``rwkv_scan_segments_plain`` (the split kernel's three steps in torch:
  states of every segment but the last from zero, the fold, every segment
  rerun from its start state) against the reference's Pallas
  ``rwkv_scan`` in interpret mode and ``ref.rwkv_scan_ref``, at 1, 2, 3
  and 7 segments, lengths 1, 5, 77 and 128 (with more segments than
  tokens), head dims 16, 32 and 64, float32 and bf16.  Tolerances as in
  ``tests/test_torch_rwkv.py``: y float32 rtol = atol = 2e-5 (float32
  throughout, sums in other orders: the fold multiplies a start state by
  a segment's product of decays where the reference applies them one
  token at a time), bf16 2e-2 (y is rounded to bf16 once), the float32
  state 1e-4.
* ``rwkv_scan_plan``: one segment at the served shapes, never more
  segments than tokens, never a segment shorter than ``MIN_SEGMENT``, the
  same plan for the same shapes; ``segment_bounds`` covers the sequence.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.kernels import rwkv_scan as rs

j_scan_mod = importlib.import_module("repro.kernels.rwkv_scan")

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
STATE_TOL = dict(rtol=1e-4, atol=1e-4)
B, H = 2, 2


def scan_inputs(s, hd, seed):
    """float32 numpy inputs as tests/test_kernels.py draws them: r, k, v
    normal, w = sigmoid(normal) in (0, 1), u = sigmoid(normal) / 2, s0
    normal / 10."""
    rng = np.random.default_rng(seed)
    sig = lambda x: 1.0 / (1.0 + np.exp(-x))
    r, k, v = (rng.standard_normal((B, s, H, hd)).astype(np.float32)
               for _ in range(3))
    w = sig(rng.standard_normal((B, s, H, hd))).astype(np.float32)
    u = (sig(rng.standard_normal((H, hd))) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.1).astype(np.float32)
    return r, k, v, w, u, s0


@functools.lru_cache(maxsize=None)
def references(s, hd, dtype_name):
    """(the port's inputs, Pallas interpret-mode result, ``ref`` result)
    for one length, head dim and dtype; r, k, v, w rounded to the dtype
    on both sides."""
    arrays = scan_inputs(s, hd, 7 * s + hd)
    jd, td = getattr(jnp, dtype_name), getattr(torch, dtype_name)
    j = [jnp.asarray(a).astype(jd) for a in arrays[:4]] + \
        [jnp.asarray(a) for a in arrays[4:]]
    t = [torch.from_numpy(a).to(td) for a in arrays[:4]] + \
        [torch.from_numpy(a) for a in arrays[4:]]
    pallas = j_scan_mod.rwkv_scan(*j, chunk=s, interpret=True)
    return t, pallas, ref.rwkv_scan_ref(*j)


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("s", [1, 5, 77, 128])
@pytest.mark.parametrize("segments", [1, 2, 3, 7])
def test_segments_plain_matches_pallas_and_ref(segments, s, hd, dtype):
    t, pallas, reference = references(s, hd, dtype)
    got_y, got_s = rs.rwkv_scan_segments_plain(*t, segments)
    assert got_y.dtype == getattr(torch, dtype)
    assert got_y.shape == (B, s, H, hd) and got_s.dtype == torch.float32
    for want_y, want_s in (pallas, reference):
        np.testing.assert_allclose(f32(got_y), f32(want_y), **TOL[dtype])
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                                   **STATE_TOL)


def test_one_segment_is_the_plain_scan():
    """One segment is the sequential scan itself, bit for bit."""
    t, _, _ = references(77, 32, "float32")
    for a, b in zip(rs.rwkv_scan_segments_plain(*t, 1),
                    rs.rwkv_scan_plain(*t)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="segments"):
        rs.rwkv_scan_segments_plain(*t, 0)


@pytest.mark.parametrize("s,segments", [(1, 1), (5, 7), (77, 3), (77, 7),
                                        (128, 2), (2048, 4)])
def test_segment_bounds_cover_the_sequence(s, segments):
    bounds = rs.segment_bounds(s, segments)
    assert len(bounds) == segments
    assert bounds[0][0] == 0 and bounds[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [t1 - t0 for t0, t1 in bounds]
    assert max(sizes) - min(sizes) <= 1 and sizes[-1] >= 1


@pytest.mark.parametrize("n_sm", [132, 114, 78])
@pytest.mark.parametrize("s", [1, 8])
def test_plan_keeps_the_served_shapes_in_one_segment(n_sm, s):
    """rwkv6-3b's served decode (S=1) and prefill (S=8) steps: B=4, 40
    heads of 64; one launch of one kernel, as before the split."""
    assert rs.rwkv_scan_plan(4, s, 40, n_sm) == 1


@pytest.mark.parametrize("b,s,h", [(4, 2048, 40), (1, 32768, 40),
                                   (1, 100, 1), (2, 77, 3), (1, 5, 2),
                                   (64, 4096, 40), (1, 64, 1),
                                   (1, 1_000_000, 2)])
@pytest.mark.parametrize("n_sm", [132, 16])
def test_plan_bounds(b, s, h, n_sm):
    """1 <= P <= S; a split leaves no segment under ``MIN_SEGMENT``
    tokens and no more blocks than one base grid past the target; a grid
    that already reaches the target is not split; the same shapes always
    give the same plan."""
    p = rs.rwkv_scan_plan(b, s, h, n_sm)
    assert 1 <= p <= s
    assert p == rs.rwkv_scan_plan(b, s, h, n_sm)
    target = rs.BLOCKS_PER_SM * n_sm
    if p > 1:
        assert s // p >= rs.MIN_SEGMENT
        assert b * h * (p - 1) < target
    if b * h >= target:
        assert p == 1


def test_plan_splits_long_prompts():
    """The long-prompt shapes of the smoke's phase 11 on a 132-SM card:
    (b) B=4, S=2048 and (c) B=1, S=32768 of rwkv6-3b's 40 heads fill
    the card with segments; a short sequence does not split."""
    assert rs.rwkv_scan_plan(4, 2048, 40, 132) > 1
    assert rs.rwkv_scan_plan(1, 32768, 40, 132) > \
        rs.rwkv_scan_plan(4, 2048, 40, 132)
    assert rs.rwkv_scan_plan(1, rs.MIN_SEGMENT * 2 - 1, 40, 132) == 1
