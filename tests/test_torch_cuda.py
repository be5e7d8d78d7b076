"""Tests of the port that need an NVIDIA GPU (marker ``cuda``; they skip
where ``torch.cuda.is_available()`` is false).  This module imports
neither jax nor the reference, so it runs on a machine with only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import fleet_inputs
from repro_torch.core.batched import BatchedAlertEngine
from repro_torch.core.profiles import synthetic_table
from repro_torch.kernels import alert_select as ks

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda", 0)


def _engine(device, paper_faithful=True):
    return BatchedAlertEngine(synthetic_table(0), None, overhead=0.001,
                              paper_faithful_energy=paper_faithful,
                              device=device)


def _consts(eng, **kw):
    return dict(latency=eng._latency, run_power=eng._run_power,
                weights=eng._weights, q_fail=eng._q_fail,
                overhead=eng.overhead, **kw)


@pytest.mark.parametrize("s", [1, 4097, 65536])
@pytest.mark.parametrize("paper_faithful", [True, False])
@pytest.mark.parametrize("predictions", [True, False])
def test_kernel_matches_plain(cuda_device, s, paper_faithful, predictions):
    """Picks, feasibility and relax codes exact, predictions bitwise: the
    kernel and the plain version round at the same places."""
    eng = _engine(cuda_device, paper_faithful)
    args = fleet_inputs(eng.table, s, seed=s, device=cuda_device)
    kw = _consts(eng, paper_faithful_energy=paper_faithful,
                 predictions=predictions)
    before = ks.alert_select.launches
    got = ks.alert_select(*args, **kw)
    torch.cuda.synchronize()
    assert ks.alert_select.launches == before + 1
    plain = ks.alert_select_plain(*args, **kw)
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cuda_engine_launches_the_kernel(cuda_device):
    eng = _engine(cuda_device)
    assert eng.backend == "cuda"
    st = np.random.default_rng(0)
    before = ks.alert_select.launches
    batch = eng.select(st.uniform(0.5, 2, 9), 0.1, 0.3,
                       st.uniform(0.1, 1, 9), accuracy_goal=0.7,
                       energy_goal=5.0, goal_kind=st.integers(0, 2, 9))
    assert ks.alert_select.launches == before + 1
    assert batch.model_index.shape == (9,)
    with pytest.raises(ValueError, match="does not run"):
        BatchedAlertEngine(eng.table, backend="torch", device=cuda_device)


def test_wrapper_rejects_bad_inputs(cuda_device):
    eng = _engine(cuda_device)
    args = fleet_inputs(eng.table, 16, seed=0, device=cuda_device)
    kw = _consts(eng)
    bad = list(args)
    bad[0] = bad[0].float()
    with pytest.raises(ValueError, match="mu must be"):
        ks.alert_select(*bad, **kw)
    bad = list(args)
    bad[6] = bad[6].long()
    with pytest.raises(ValueError, match="goal_kind must be"):
        ks.alert_select(*bad, **kw)
    bad = list(args)
    bad[2] = torch.stack([bad[2], bad[2]], 1)[:, 0]
    with pytest.raises(ValueError, match="contiguous"):
        ks.alert_select(*bad, **kw)
    big = synthetic_table(0, n_single=30, n_levels=4, n_power=8)
    with pytest.raises(ValueError, match="exceeds the kernel's limits"):
        BatchedAlertEngine(big, None, device=cuda_device)
    big_cpu = BatchedAlertEngine(big, None, device="cpu")
    with pytest.raises(ValueError, match="exceeds the kernel's limits"):
        ks.alert_select(*args, **{
            k: (v.to(cuda_device) if torch.is_tensor(v) else v)
            for k, v in _consts(big_cpu).items()})


def test_model_on_card_matches_cpu(cuda_device):
    """The reduced float32 model: card logits within 1e-4 of the CPU's
    (TF32 off; the card sums in another order)."""
    from chip_smoke import model_cpu_vs_card

    torch.backends.cuda.matmul.allow_tf32 = False
    assert model_cpu_vs_card(cuda_device) < 1e-4


# --------------------------------------------------------------------- #
# nested_matmul                                                          #
# --------------------------------------------------------------------- #
def _full_width_geometries():
    from chip_smoke import projection_geometries
    from repro_torch.configs.alert_anytime import CONFIG

    return projection_geometries(CONFIG)


@pytest.mark.parametrize("geometry", [0, 1, 2],
                         ids=["d->d", "d->d_ff", "d_ff->d"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_nested_matmul_matches_plain(cuda_device, geometry, dtype):
    """Every level, M in {4, 32}, a level-prefix view of x and the full w,
    within chip_smoke.NM_TOL (float32 with TF32 off)."""
    from chip_smoke import nested_close

    from repro_torch.kernels import nested_matmul as nm

    torch.backends.cuda.matmul.allow_tf32 = False
    _, si, so = _full_width_geometries()[geometry]
    gen = torch.Generator(device=cuda_device).manual_seed(geometry)
    w = torch.randn(si.total, so.total, generator=gen,
                    device=cuda_device).to(getattr(torch, dtype))
    for m in (4, 32, 37):
        x = torch.randn(m, si.total, generator=gen,
                        device=cuda_device).to(w.dtype)
        for level in range(1, so.levels + 1):
            xk = x[:, :si.width(min(level, si.levels))]
            got = nm.nested_matmul(xk, w, si, so, level)
            torch.cuda.synchronize()
            assert got.shape == (m, so.width(level)) and got.dtype == w.dtype
            _, ratio = nested_close(got, nm.nested_matmul_plain(
                xk, w, si, so, level), dtype)
            assert ratio <= 1.0, (m, level, ratio)


def test_nested_matmul_reads_weight_through_stride(cuda_device):
    """A column slice of a wider weight is read in place: equal to the
    kernel on a contiguous copy, and the call allocates only its output."""
    from repro_torch.kernels import nested_matmul as nm

    _, si, so = _full_width_geometries()[0]
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    wide = torch.randn(si.total, so.total + 64, generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    w = wide[:, :so.total]
    assert not w.is_contiguous()
    x = torch.randn(32, si.total, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    want = nm.nested_matmul(x, w.contiguous(), si, so, 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    got = nm.nested_matmul(x, w, si, so, 3)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert torch.equal(got, want)
    assert peak <= got.numel() * got.element_size() + 4096


def test_nested_matmul_counts_launches_and_rejects(cuda_device):
    from repro_torch.kernels import nested_matmul as nm

    si, so = _full_width_geometries()[1][1:]
    x = torch.randn(4, si.total, device=cuda_device)
    w = torch.randn(si.total, so.total, device=cuda_device)
    before = nm.nested_matmul.launches
    nm.nested_matmul(x, w, si, so)
    nm.nested_matmul(x, w, si, so, 2)
    assert nm.nested_matmul.launches == before + 2
    bad = [
        (x, w.cpu()),                                 # mixed devices
        (x.half(), w.half()),                         # unsupported dtype
        (x.bfloat16(), w),                            # mismatched dtypes
        (x[:, :96], w),                               # x narrower than L4
        (x, w.t().contiguous().t()),                  # column-strided w
        (x[None], w),                                 # not 2-D
    ]
    for xb, wb in bad:
        with pytest.raises(ValueError, match="nested_matmul: needs"):
            nm.nested_matmul(xb, wb, si, so)
    assert nm.nested_matmul.launches == before + 2


def test_kernel_backend_model_on_card_matches_cpu(cuda_device):
    """The reduced float32 model with the kernel nest backend on the card
    within 1e-4 of the blocks backend on the CPU."""
    from chip_smoke import model_cpu_vs_card
    from repro_torch.kernels import nested_matmul as nm

    torch.backends.cuda.matmul.allow_tf32 = False
    before = nm.nested_matmul.launches
    assert model_cpu_vs_card(cuda_device, backend="kernel") < 1e-4
    assert nm.nested_matmul.launches > before


# --------------------------------------------------------------------- #
# flash_attention and decode_attention                                   #
# --------------------------------------------------------------------- #
FLASH_CARD = {
    "main-path-h1": (4, 8, 1, 1, 96, {}),
    "main-path-h8": (4, 8, 8, 8, 96, {}),
    "gemma-window": (1, 1024, 4, 1, 256, {"window": 512}),
    "gemma-softcap": (1, 1024, 4, 1, 256, {"window": 512, "softcap": 50.0}),
    "ragged-gqa": (2, 37, 6, 2, 64, {"causal": False}),
    "pad-hd8": (2, 100, 2, 2, 8, {}),          # zero-padded to 32 in smem
    "pad-hd40": (2, 100, 4, 2, 40, {}),        # zero-padded to 64
    "hd128": (2, 300, 4, 4, 128, {}),
    "ragged-causal-s100": (2, 100, 8, 8, 96, {}),   # wgmma, ragged tile
    "wgmma-hd72-gqa": (2, 150, 4, 2, 72, {}),      # wgmma, padded to 96
    "wgmma-window": (1, 1000, 2, 1, 96, {"window": 100}),
    "wgmma-softcap": (2, 200, 4, 2, 96, {"softcap": 50.0}),
    "wgmma-bidirectional": (2, 200, 4, 2, 96, {"causal": False}),
    # the encoder-decoder: S != T, no causal mask, hd 64
    "whisper-cross-s4-t1500": (4, 4, 6, 6, 64, {"t": 1500,
                                                "causal": False}),
    "whisper-cross-s1-t1500": (2, 1, 6, 6, 64, {"t": 1500,
                                                "causal": False}),
    "whisper-encoder-s1500": (1, 1500, 6, 6, 64, {"causal": False}),
    "whisper-s37-t100": (2, 37, 6, 6, 64, {"t": 100, "causal": False}),
    "whisper-decoder-self-s4": (4, 4, 6, 6, 64, {}),    # causal, hd 64
    "s100-t37": (2, 100, 4, 2, 64, {"t": 37, "causal": False}),
}
DECODE_CARD = {
    "main-path-h1": (4, 12, 1, 1, 96, [9, 10, 11, 12], {}),
    "main-path-h8": (4, 12, 8, 8, 96, 11, {}),
    "gemma-global": (4, 32768, 4, 1, 256, 32768, {}),
    "gemma-window": (4, 32768, 4, 1, 256, [32768, 3000, 600, 1],
                     {"window": 512}),
    "ragged-gqa": (3, 77, 6, 2, 64, [77, 5, 40], {}),
    "split-b1": (1, 32768, 8, 1, 128, 32768, {}),
    "split-ragged": (4, 32768, 4, 1, 256, [32768, 31, 0, 4097], {}),
    "split-window-rows": (3, 4096, 4, 2, 64, [4096, 100, 2000],
                          {"window": 300}),
    "whisper-cross-t1500": (4, 1500, 6, 6, 64, 1500, {}),
}


@pytest.mark.parametrize("case", list(FLASH_CARD))
def test_flash_attention_matches_plain(cuda_device, case):
    """bf16 and float32 within chip_smoke.ATT_TOL: the worst error is at
    most the tolerance (flash_case also raises past it)."""
    from chip_smoke import flash_case

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, hd, kw = FLASH_CARD[case]
    assert flash_case(cuda_device, case, b, s, h, kv, hd,
                      **kw)["ratio"] <= 1.0


@pytest.mark.parametrize("case", list(DECODE_CARD))
def test_decode_attention_matches_plain(cuda_device, case):
    """As :func:`test_flash_attention_matches_plain`, for decode."""
    from chip_smoke import decode_case

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, hd, lens, kw = DECODE_CARD[case]
    assert decode_case(cuda_device, case, b, s, h, kv, hd, lens,
                       **kw)["ratio"] <= 1.0


def _decode_inputs(device, case, dtype):
    b, s, h, kv, hd, lens, kw = DECODE_CARD[case]
    gen = torch.Generator(device=device).manual_seed(11)
    q, k, v = (torch.randn(shape, generator=gen, device=device).to(dtype)
               for shape in ((b, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
    cache_len = lens if isinstance(lens, int) else torch.tensor(
        lens, dtype=torch.int32, device=device)
    return q, k, v, cache_len, kw


@pytest.mark.parametrize("case", ["gemma-global", "split-b1", "split-ragged",
                                  "split-window-rows"])
def test_split_call_matches_one_split_plan(cuda_device, monkeypatch, case):
    """The plan's split call (two CUDA launches) against the same call
    with the plan monkeypatched to one split (today's one-block path),
    bf16 and float32, within chip_smoke.ATT_TOL; one count each."""
    from chip_smoke import attention_close
    from repro_torch.kernels import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, hd, _, kw = DECODE_CARD[case]
    splits, _ = da.decode_split_plan(b, kv, h // kv, s, kw.get("window"),
                                     da.sm_count(cuda_device))
    assert splits > 1
    for dt in ("bfloat16", "float32"):
        q, k, v, cache_len, kw = _decode_inputs(cuda_device, case,
                                                getattr(torch, dt))
        before = da.decode_attention.launches
        got = da.decode_attention(q, k, v, cache_len, **kw)
        with monkeypatch.context() as m:
            m.setattr(da, "decode_split_plan", lambda b, kv, g, s, window,
                      n_sm: (1, max(da.max_row_tiles(s, window), 1)))
            one = da.decode_attention(q, k, v, cache_len, **kw)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 2
        vscale = da.decode_attention_plain(q.float(), k.float(),
                                           v.float().abs(), cache_len, **kw)
        _, ratio = attention_close(got, one, vscale, dt, f"{case} {dt}")
        assert ratio <= 1.0


@pytest.mark.parametrize("splits", [2, 7, 300])
def test_split_kernel_matches_split_plain(cuda_device, monkeypatch, splits):
    """The kernel with the plan monkeypatched to ``splits`` runs (300:
    more runs than a short row has tiles, so some see no position)
    against decode_attention_split_plain at the same count."""
    from chip_smoke import attention_close
    from repro_torch.kernels import decode_attention as da

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(da, "decode_split_plan", lambda b, kv, g, s, window,
                        n_sm: (splits, -(-max(da.max_row_tiles(s, window),
                                              1) // splits)))
    for case in ("split-ragged", "split-window-rows"):
        for dt in ("bfloat16", "float32"):
            q, k, v, cache_len, kw = _decode_inputs(cuda_device, case,
                                                    getattr(torch, dt))
            got = da.decode_attention(q, k, v, cache_len, **kw)
            torch.cuda.synchronize()
            want = da.decode_attention_split_plain(q, k, v, cache_len,
                                                   splits=splits, **kw)
            vscale = da.decode_attention_plain(q.float(), k.float(),
                                               v.float().abs(), cache_len,
                                               **kw)
            _, ratio = attention_close(got, want, vscale, dt,
                                       f"{case} {dt} {splits} splits")
            assert ratio <= 1.0


def _attention_inputs(device, dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(7)
    q = torch.randn(4, 64, 8, 96, generator=gen, device=device).to(dtype)
    k = torch.randn(4, 64, 8, 96, generator=gen, device=device).to(dtype)
    return q, k, torch.randn_like(k)


def test_attention_calls_allocate_only_output_and_count(cuda_device):
    """Each call allocates its output and, for a split decode call, the
    workspace that decode_attention_workspace_bytes reports, nothing
    more; one count per call."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _attention_inputs(cuda_device)
    qd = q[:, 0]                                     # a strided view
    fa.flash_attention(q, k, v)
    da.decode_attention(qd, k, v, 50)
    torch.cuda.synchronize()
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    ws = da.decode_attention_workspace_bytes(
        4, 64, 8, 8, 96, n_sm=da.sm_count(cuda_device))
    assert ws > 0                                    # this call splits
    for call, extra in ((lambda: fa.flash_attention(q, k, v, window=9), 0),
                        (lambda: da.decode_attention(qd, k, v, 50), ws)):
        torch.cuda.reset_peak_memory_stats(cuda_device)
        base = torch.cuda.memory_allocated(cuda_device)
        out = call()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(cuda_device) - base
        assert peak <= out.numel() * out.element_size() + extra + 4096
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(da.decode_attention(qd, k, v, 50),
                       da.decode_attention(qd.contiguous(), k, v,
                                           torch.full((4,), 50,
                                                      device=cuda_device)))


def test_attention_wrappers_reject(cuda_device):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _attention_inputs(cuda_device)
    odd = torch.empty(q.numel() + 1, dtype=q.dtype,
                      device=cuda_device)[1:].view(q.shape)
    bad = {
        "head_dim": (q[..., :12], k[..., :12], v[..., :12]),
        "dtype": (q.half(), k.half(), v.half()),
        "mixed devices": (q, k.cpu(), v),
        "mixed dtypes": (q, k.float(), v),
        "gqa": (q, k[:, :, :3], v[:, :, :3]),
        "alignment": (odd, k, v),
    }
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    for what, (qb, kb, vb) in bad.items():
        with pytest.raises(ValueError, match="flash_attention"):
            fa.flash_attention(qb, kb, vb)
        with pytest.raises(ValueError, match="decode_attention"):
            da.decode_attention(qb[:, 0], kb, vb, 10)
    with pytest.raises(ValueError, match="cache_len"):
        da.decode_attention(q[:, 0], k, v, torch.tensor([10] * 4))
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == before


def test_kernel_attention_decode_with_softcap_raises(cuda_device):
    from repro_torch.configs.alert_anytime import reduced
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import ServeEngine

    cfg = reduced().replace(attn_backend="kernel", attn_logit_softcap=30.0)
    params = tfm.init_lm(cfg, device=cuda_device)
    toks = torch.zeros((2, 6), dtype=torch.long, device=cuda_device)
    out = tfm.lm_apply(params, cfg, toks)
    eng = ServeEngine(build_model(cfg), max_len=8, batch_size=2,
                      device=cuda_device)
    caches = eng._merge(eng.init_caches(), out.caches)
    with pytest.raises(ValueError, match="no logit softcap"):
        tfm.lm_apply(params, cfg, toks[:, :1], mode="decode", caches=caches,
                     cache_len=6)


def test_all_kernel_model_on_card_matches_cpu(cuda_device):
    """The reduced float32 model (head_dim 8) with both kernel backends
    on the card within 1e-4 of blocks/ref on the CPU."""
    from chip_smoke import model_cpu_vs_card
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    assert model_cpu_vs_card(cuda_device, backend="kernel",
                             attn_backend="kernel") < 1e-4
    assert fa.flash_attention.launches > before[0]
    assert da.decode_attention.launches > before[1]


# --------------------------------------------------------------------- #
# the dense family's attention geometries and models                      #
# --------------------------------------------------------------------- #
FLASH_DENSE = {
    "g5-hd128-served": (4, 8, 40, 8, 128, {}),      # qwen2.5-14b
    "g5-hd128-ragged": (2, 300, 10, 2, 128, {}),
    "g3-hd128": (2, 100, 6, 2, 128, {}),
    "g4-hd160-served": (4, 8, 32, 8, 160, {}),      # stablelm-12b
    "g4-hd160": (2, 200, 8, 2, 160, {}),            # padded to 192
    "g3-hd160-window": (1, 300, 6, 2, 160, {"window": 100}),
    "g4-hd256-window512-served": (4, 8, 4, 1, 256,
                                  {"window": 512}),           # gemma3-1b
    "g4-hd256-window512-s1000": (1, 1000, 4, 1, 256, {"window": 512}),
    "g5-hd256-window512": (1, 1024, 5, 1, 256, {"window": 512}),
    "g1-hd128-kv16-served": (4, 8, 16, 16, 128, {}),  # olmoe-1b-7b
    "g1-hd128-kv16-ragged": (2, 300, 16, 16, 128, {}),
    "g8-hd128-kv4-served": (4, 8, 32, 4, 128, {}),    # qwen3-moe-30b-a3b
    "g8-hd128-kv4-ragged": (2, 300, 32, 4, 128, {}),
    "g4-hd128-kv8-served": (4, 8, 32, 8, 128, {}),    # jamba-v0.1-52b
    "g6-hd128-kv2-served": (4, 8, 12, 2, 128, {}),    # qwen2-vl-2b
    "g6-hd128-kv2-ragged": (2, 300, 12, 2, 128, {}),
}
DECODE_DENSE = {
    "g5-hd128-rows": (4, 12, 40, 8, 128, [9, 10, 11, 12], {}),
    "g5-hd128-scalar": (4, 12, 40, 8, 128, 12, {}),
    "g3-hd128-rows": (3, 77, 6, 2, 128, [77, 5, 40], {}),
    "g4-hd160-rows": (4, 12, 32, 8, 160, [12, 3, 7, 12], {}),
    "g5-hd160-window-rows": (3, 2048, 10, 2, 160, [2048, 600, 1],
                             {"window": 512}),
    "g4-hd256-window512-served": (4, 12, 4, 1, 256, [9, 10, 11, 12],
                                  {"window": 512}),           # gemma3-1b
    "g4-hd256-window512": (4, 1028, 4, 1, 256, [1028, 1025, 700, 513],
                           {"window": 512}),
    "g3-hd256-window512-rows": (2, 1100, 6, 2, 256, [1100, 530],
                                {"window": 512}),
    "g5-hd128-window512-rows": (4, 2048, 40, 8, 128, [2048, 1500, 700, 3],
                                {"window": 512}),
    "g1-hd128-kv16-rows-served": (4, 12, 16, 16, 128, [9, 10, 11, 12],
                                  {}),                        # olmoe-1b-7b
    "g1-hd128-kv16-ragged": (3, 777, 16, 16, 128, [777, 65, 1], {}),
    "g8-hd128-kv4-rows-served": (4, 12, 32, 4, 128, [9, 10, 11, 12],
                                 {}),                         # qwen3-moe
    "g8-hd128-kv4-ragged": (3, 2048, 32, 4, 128, [2048, 700, 3], {}),
    "g4-hd128-kv8-rows-served": (4, 12, 32, 8, 128, [9, 10, 11, 12],
                                 {}),                         # jamba
    "g6-hd128-kv2-rows-served": (4, 12, 12, 2, 128, [9, 10, 11, 12],
                                 {}),                         # qwen2-vl
    "g6-hd128-kv2-ragged": (3, 2048, 12, 2, 128, [2048, 700, 3], {}),
}


@pytest.mark.parametrize("case", list(FLASH_DENSE))
def test_flash_attention_dense_geometries(cuda_device, case):
    """g = 1 (MHA over 16 KV heads), 3, 4, 5, 6 and 8, hd 128, 160 (the hd-192
    instance, zero padding) and 256, windows that start inside a key tile,
    bf16 and float32 within ``chip_smoke.ATT_TOL``."""
    from chip_smoke import flash_case

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, hd, kw = FLASH_DENSE[case]
    assert flash_case(cuda_device, case, b, s, h, kv, hd,
                      **kw)["ratio"] <= 1.0


@pytest.mark.parametrize("case", list(DECODE_DENSE))
def test_decode_attention_dense_geometries(cuda_device, case):
    """g = 3, 5 and 6 (a last block of a KV head with 1, 2 or 3 of its 4
    head slots live), g = 1 over 16 KV heads, g = 4 (one full block a KV
    head) and g = 8 (two full 4-head blocks a KV head), hd 128, 160 (20
    lanes a row) and 256, per-row lengths
    with and without window 512; the launched kernels are the split
    plan's (``chip_smoke.decode_case`` reads them from a graph)."""
    from chip_smoke import decode_case

    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, hd, lens, kw = DECODE_DENSE[case]
    assert decode_case(cuda_device, case, b, s, h, kv, hd, lens,
                       **kw)["ratio"] <= 1.0


def test_decode_attention_g5_leaves_no_slot_written(cuda_device):
    """g=5 on 4-head blocks: the output is exactly ``[B, 40, hd]`` and a
    view into a larger buffer is left untouched past it (the three dead
    slots of each KV head's second block write nothing)."""
    from repro_torch.kernels import decode_attention as da

    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((4, 40, 128), generator=gen, device=cuda_device)
    k, v = (torch.randn((4, 12, 8, 128), generator=gen, device=cuda_device)
            for _ in range(2))
    out = da.decode_attention(q, k, v, 12)
    assert out.shape == (4, 40, 128)
    torch.testing.assert_close(out, da.decode_attention_plain(q, k, v, 12),
                               rtol=1e-5, atol=1e-5)
    assert da.heads_per_block(5) == 4


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "gemma3-1b"])
def test_dense_model_on_card_matches_cpu(cuda_device, arch):
    """Reduced float32 model, ``attn_backend="kernel"``: the kernels on
    the card within 1e-4 of their plain versions on the CPU, prefill and
    3 decode steps (``chip_smoke.dense_model_cpu_vs_card``)."""
    from chip_smoke import dense_model_cpu_vs_card

    torch.backends.cuda.matmul.allow_tf32 = False
    assert dense_model_cpu_vs_card(cuda_device, arch) < 1e-4


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_per_row_cache_len_decode_replays_in_a_graph(cuda_device, backend):
    """A decode step of reduced gemma3 (window 8) with a ``[B]`` int32
    ``cache_len`` on the card, captured once in a CUDA graph and replayed
    at two length vectors: each replay equals the eager step on the CPU
    at the same lengths (the per-row cache write and mask are read on the
    device, not the host)."""
    import numpy as np

    from chip_smoke import copy_params
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("gemma3-1b").replace(dtype="float32",
                                           attn_backend=backend)
    cpu = torch.device("cpu")
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), device=cpu)
    card = copy_params(params, cuda_device)
    rng = np.random.default_rng(3)
    caches0 = [tuple(torch.from_numpy(rng.standard_normal(
        (3, 20, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32))
        for _ in range(2)) for _ in range(cfg.n_layers)]
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (3, 1)))
    lens = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    tok_c = tok.to(cuda_device)
    caches_c = [tfm.attn_mod.KVCache(*(x.to(cuda_device) for x in c))
                for c in caches0]

    def step():
        return tfm.lm_apply(card, cfg, tok_c, mode="decode",
                            caches=caches_c, cache_len=lens).logits

    with torch.inference_mode():
        lens.copy_(torch.tensor([1, 2, 3]))
        step()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = step()
        for want_lens in ([0, 19, 9], [12, 4, 17]):
            for c, c0 in zip(caches_c, caches0):
                for x, x0 in zip(c, c0):
                    x.copy_(x0)
            lens.copy_(torch.tensor(want_lens))
            graph.replay()
            torch.cuda.synchronize()
            ref_caches = [tfm.attn_mod.KVCache(*(x.clone() for x in c))
                          for c in caches0]
            want = tfm.lm_apply(params, cfg, tok, mode="decode",
                                caches=ref_caches, cache_len=torch.tensor(
                                    want_lens, dtype=torch.int32)).logits
            torch.testing.assert_close(out.cpu(), want, rtol=1e-4,
                                       atol=1e-4)
            for c, r in zip(caches_c, ref_caches):
                for x, y in zip(c, r):
                    torch.testing.assert_close(x.cpu(), y, rtol=1e-4,
                                               atol=1e-4)


# --------------------------------------------------------------------- #
# the MoE family                                                         #
# --------------------------------------------------------------------- #
# (experts, top_k, tokens B x S, capacity factor): olmoe-like and
# qwen3-moe-like routing at a served prefill (32 tokens, one group) and
# decode step (4 tokens), and a prefill at capacity factor 0.25 (drops).
MOE_BLOCK = {
    "olmoe-prefill": (64, 8, (4, 8), 1.25),
    "olmoe-decode": (64, 8, (4, 1), 1.25),
    "qwen3-moe-prefill": (128, 8, (4, 8), 1.25),
    "qwen3-moe-decode": (128, 8, (4, 1), 1.25),
    "olmoe-prefill-drops": (64, 8, (4, 8), 0.25),
}


def _moe_block(case, dispatch):
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe as moe_mod

    e, k, (b, s), factor = MOE_BLOCK[case]
    cfg = get_reduced("olmoe-1b-7b").replace(
        dtype="float32", d_model=256, d_ff=128, n_experts=e, top_k=k,
        capacity_factor=factor, moe_dispatch=dispatch)
    params = moe_mod.moe_init(cfg, torch.Generator().manual_seed(0),
                              torch.device("cpu"))
    x = torch.randn((b, s, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    return cfg, params, x


@pytest.mark.parametrize("dispatch", ["onehot", "gather"])
@pytest.mark.parametrize("case", list(MOE_BLOCK))
def test_moe_block_on_card_matches_cpu(cuda_device, case, dispatch):
    """The MoE block in float32 (TF32 off) on the card against the CPU:
    every routed id equal, output and aux loss within 1e-4; two calls on
    the card bitwise equal (no atomics in the sums)."""
    from chip_smoke import dropped_assignments, recording_routes
    from repro_torch.models import moe as moe_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params, x = _moe_block(case, dispatch)
    card = {n: w.to(cuda_device) for n, w in params.items()}
    with recording_routes() as cpu_ids:
        want, want_aux = moe_mod.moe(params, x, cfg)
    with recording_routes() as card_ids:
        got, aux = moe_mod.moe(card, x.to(cuda_device), cfg)
        again, aux2 = moe_mod.moe(card, x.to(cuda_device), cfg)
    assert torch.equal(card_ids[0].cpu(), cpu_ids[0])
    assert torch.equal(card_ids[1], card_ids[0])
    if case.endswith("drops"):
        assert dropped_assignments(cpu_ids[0], cfg) > 0
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-4, atol=1e-4)
    assert torch.equal(again, got) and torch.equal(aux2, aux)


@pytest.mark.parametrize("dispatch", ["onehot", "gather"])
def test_moe_block_replays_in_a_graph(cuda_device, dispatch):
    """The bf16 block (float32 router) captured in a CUDA graph and
    replayed on new inputs: bitwise equal to the eager call, with no
    host read in the block (the capture would fail on one)."""
    from repro_torch.models import moe as moe_mod

    cfg, params, x = _moe_block("olmoe-prefill", dispatch)
    cfg = cfg.replace(dtype="bfloat16")
    card = {n: (w if n == "router" else w.to(torch.bfloat16)).to(
        cuda_device) for n, w in params.items()}
    xs = torch.randn((3,) + tuple(x.shape), generator=torch.Generator(
    ).manual_seed(2)).to(cuda_device, torch.bfloat16)
    static = xs[0].clone()
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            moe_mod.moe(card, static, cfg, with_aux=False)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = moe_mod.moe(card, static, cfg, with_aux=False)
        for x_i in xs:
            static.copy_(x_i)
            graph.replay()
            want, _ = moe_mod.moe(card, x_i, cfg, with_aux=False)
            assert out.dtype == torch.bfloat16
            assert torch.equal(out, want)


@pytest.mark.parametrize("arch,factor", [("olmoe-1b-7b", None),
                                         ("qwen3-moe-30b-a3b", None),
                                         ("olmoe-1b-7b", 0.25)])
def test_moe_model_on_card_matches_cpu(cuda_device, arch, factor):
    """Reduced float32 MoE model, ``attn_backend="kernel"``: within 1e-4
    of the CPU, prefill and 3 decode steps, every layer's routed ids
    equal (``chip_smoke.moe_model_cpu_vs_card``); at capacity factor 0.25
    the prefill drops assignments."""
    from chip_smoke import moe_model_cpu_vs_card

    torch.backends.cuda.matmul.allow_tf32 = False
    out = moe_model_cpu_vs_card(cuda_device, arch, factor)
    assert out["max_abs_diff"] < 1e-4
    assert factor is None or out["prefill_dropped"] > 0


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-vl-2b"])
def test_hybrid_and_vlm_models_on_card_match_cpu(cuda_device, arch):
    """Reduced float32 ``jamba-v0.1-52b`` (Mamba, attention and MoE
    layers) and ``qwen2-vl-2b`` (three distinct M-RoPE streams),
    ``attn_backend="kernel"``: within 1e-4 of the CPU, prefill and 3
    decode steps, every cache and every routed id
    (``chip_smoke.reduced_cpu_vs_card``); the attention kernels launch
    once per attention layer a forward."""
    from chip_smoke import reduced_cpu_vs_card
    from repro_torch.configs import get_reduced

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch).replace(dtype="float32", attn_backend="kernel")
    out = reduced_cpu_vs_card(cuda_device, cfg, pos3d=arch == "qwen2-vl-2b")
    assert out["max_abs_diff"] < 1e-4
    n_attn = sum(m == "attn" for m, _ in cfg.layer_plan())
    assert out["launches"] == [n_attn, 3 * n_attn]


def test_whisper_on_card_matches_cpu(cuda_device):
    """Reduced float32 ``whisper-tiny``, ``attn_backend="kernel"``: within
    1e-4 of the CPU, prefill (logits, self caches, cross k/v) and 3 decode
    steps at per-row lengths (``chip_smoke.whisper_cpu_vs_card``);
    ``flash_attention`` once per encoder layer and twice per decoder
    layer in the prefill, ``decode_attention`` twice per decoder layer a
    step."""
    from chip_smoke import whisper_cpu_vs_card

    torch.backends.cuda.matmul.allow_tf32 = False
    out = whisper_cpu_vs_card(cuda_device)
    assert out["max_abs_diff"] < 1e-4
    assert out["launches"] == [6, 12]


def test_whisper_graphed_decode_matches_eager(cuda_device):
    """Reduced bf16 ``whisper-tiny`` through ``chip_smoke.whisper_serve``
    at 100 frames, a 40-slot cache and 6 steps: prefill and decode
    captured as CUDA graphs over static buffers (a ``[B]`` device
    ``cache_len``, the cross k/v of one request) give the eager steps'
    tokens bitwise, with the launches each graph's kernel nodes show."""
    from chip_smoke import whisper_serve
    from repro_torch.configs import get_reduced

    out = whisper_serve(cuda_device, get_reduced("whisper-tiny"),
                        frames=100, slots=40, steps=6)
    assert out["graph_launches"] == {"prefill": (0, 6, 0, 0),
                                     "decode": (0, 0, 4, 0)}
    assert len(out["tokens"][0]) == 7


def _mamba_block(dtype):
    from repro_torch.configs import get_reduced
    from repro_torch.models import mamba as mb

    cfg = get_reduced("jamba-v0.1-52b").replace(dtype=dtype, d_model=256)
    params = mb.mamba_init(cfg, torch.Generator().manual_seed(0),
                           torch.device("cpu"))
    gen = torch.Generator().manual_seed(1)
    for name in ("conv_b", "dt_bias"):
        params[name].normal_(0.0, 0.5, generator=gen)
    return cfg, params


@pytest.mark.parametrize("s", [1, 2, 8, 20])
def test_mamba_block_on_card_matches_cpu(cuda_device, s):
    """The float32 Mamba block (TF32 off) on the card against the CPU,
    from a state: output and both state leaves within 1e-4."""
    from repro_torch.models import mamba as mb

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, params = _mamba_block("float32")
    gen = torch.Generator().manual_seed(s)
    x = torch.randn((3, s, cfg.d_model), generator=gen)
    st = mb.MambaState(
        torch.randn((3, cfg.mamba_d_inner, cfg.mamba_d_state),
                    generator=gen),
        torch.randn((3, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
                    generator=gen))
    want, want_st = mb.mamba(params, x, cfg, state=st)
    card = {n: w.to(cuda_device) for n, w in params.items()}
    got, got_st = mb.mamba(card, x.to(cuda_device), cfg, state=mb.MambaState(
        *(t.to(cuda_device) for t in st)))
    for a, b in ((got, want), (got_st.ssm, want_st.ssm),
                 (got_st.conv, want_st.conv)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [1, 8])
def test_mamba_block_replays_in_a_graph(cuda_device, s):
    """The bf16 block (its four float32 leaves float32) captured in a
    CUDA graph, from a state, replayed twice on new inputs and states:
    output and both state leaves bitwise equal to the eager call, with no
    host read in the block (the capture would fail on one)."""
    from repro_torch.models import mamba as mb

    cfg, params = _mamba_block("bfloat16")
    card = {n: w.to(cuda_device) for n, w in params.items()}
    gen = torch.Generator().manual_seed(2)
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    inputs = [(torch.randn((4, s, cfg.d_model), generator=gen),
               torch.randn((4, di, ds), generator=gen),
               torch.randn((4, dc - 1, di), generator=gen))
              for _ in range(3)]
    inputs = [(x.to(cuda_device, torch.bfloat16), h.to(cuda_device),
               c.to(cuda_device, torch.bfloat16)) for x, h, c in inputs]
    static = [t.clone() for t in inputs[0]]
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mb.mamba(card, static[0], cfg, state=mb.MambaState(*static[1:]))
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, new = mb.mamba(card, static[0], cfg,
                                state=mb.MambaState(*static[1:]))
        for x, h, c in inputs[1:]:
            for buf, t in zip(static, (x, h, c)):
                buf.copy_(t)
            graph.replay()
            want, want_st = mb.mamba(card, x, cfg,
                                     state=mb.MambaState(h, c))
            assert out.dtype == new.conv.dtype == torch.bfloat16
            assert new.ssm.dtype == torch.float32
            assert torch.equal(out, want)
            assert torch.equal(new.ssm, want_st.ssm)
            assert torch.equal(new.conv, want_st.conv)


# --------------------------------------------------------------------- #
# rwkv_scan                                                              #
# --------------------------------------------------------------------- #
RWKV_CARD = {  # (b, s, h, hd, strided)
    "main-path-prefill": (4, 8, 40, 64, False),
    "main-path-decode": (4, 1, 40, 64, False),
    "ragged-hd16": (2, 77, 3, 16, False),
    "ragged-hd32": (3, 45, 2, 32, False),
    "ragged-hd64-strided": (2, 77, 3, 64, True),
    "strided-hd16": (1, 33, 4, 16, True),
    "long-hd64": (1, 1000, 5, 64, False),
}


@pytest.mark.parametrize("case", list(RWKV_CARD))
def test_rwkv_scan_matches_plain(cuda_device, case):
    """bf16 and float32, y and the final state within
    chip_smoke.RS_TOL (rwkv_case also raises past it); strided cases read
    r/k/v/w as views of one [B,S,4*H*hd] tensor."""
    from chip_smoke import rwkv_case

    b, s, h, hd, strided = RWKV_CARD[case]
    assert rwkv_case(cuda_device, case, b, s, h, hd,
                     strided=strided)["ratio"] <= 1.0


def _rwkv_inputs(device, b=2, s=9, h=3, hd=32):
    from chip_smoke import rwkv_inputs

    gen = torch.Generator(device=device).manual_seed(9)
    return rwkv_inputs(gen, b, s, h, hd, device)


def test_rwkv_scan_counts_launches_and_allocates_only_outputs(cuda_device):
    from repro_torch.kernels import rwkv_scan as rs

    x = _rwkv_inputs(cuda_device)
    rs.rwkv_scan(*x)
    torch.cuda.synchronize()
    before = rs.rwkv_scan.launches
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    y, s_n = rs.rwkv_scan(*x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert peak <= y.numel() * 4 + s_n.numel() * 4 + 4096
    assert rs.rwkv_scan.launches == before + 1
    assert y.dtype == torch.float32 and s_n.dtype == torch.float32
    rs.rwkv_scan_plain(*x)
    assert rs.rwkv_scan.launches == before + 1


def test_rwkv_scan_rejects_without_fallback(cuda_device):
    """What the kernel does not take raises; nothing runs the plain
    version instead."""
    from repro_torch.kernels import rwkv_scan as rs

    r, k, v, w, u, s0 = _rwkv_inputs(cuda_device)
    odd = torch.empty(r.numel() + 1, dtype=r.dtype,
                      device=cuda_device)[1:].view(r.shape)
    odd.copy_(r)
    bad = {
        "alignment": ((odd, k, v, w, u, s0), "aligned"),
        "head_dim": ((r[..., :8], k[..., :8], v[..., :8], w[..., :8],
                      u[:, :8], s0[..., :8, :8]), "head_dim"),
        "dtype": ((r.half(), k.half(), v.half(), w.half(), u, s0),
                  "float32 or bfloat16"),
        "mixed devices": ((r, k.cpu(), v, w, u, s0), "one device"),
        "state dtype": ((r, k, v, w, u, s0.double()), "float32"),
    }
    before = rs.rwkv_scan.launches
    for what, (args, match) in bad.items():
        with pytest.raises(ValueError, match=match):
            rs.rwkv_scan(*args)
    assert rs.rwkv_scan.launches == before


def test_rwkv_model_on_card_matches_cpu(cuda_device):
    """The reduced float32 RWKV-6 model (hd 32) on the card, its scans on
    the kernel, within 1e-4 of the CPU's plain scans: prefill and 3
    decode steps, logits and every state leaf."""
    from chip_smoke import rwkv_model_cpu_vs_card
    from repro_torch.kernels import rwkv_scan as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    before = rs.rwkv_scan.launches
    assert rwkv_model_cpu_vs_card(cuda_device) < 1e-4
    assert rs.rwkv_scan.launches == before + 4 * 2   # 4 forwards x 2 layers


# --------------------------------------------------------------------- #
# nested_matmul v3: odd shapes, determinism, graphs                       #
# --------------------------------------------------------------------- #
def _odd_specs():
    """Stripes of 24-104 columns (no multiple of the 64-column tile) over
    input prefixes of 40, 100, 200 and 328 (100 is no multiple of 8, none
    of the 64-row step): rows stay 16-byte aligned, so the v3 kernel runs
    and masks each column at its own limit."""
    from repro_torch.core.nesting import StripeSpec

    return StripeSpec((0, 40, 100, 200, 328)), StripeSpec((0, 24, 72, 176,
                                                           264))


@pytest.mark.parametrize("m", [1, 4, 5, 32, 33])
def test_nested_matmul_v3_odd_limits_and_stripes(cuda_device, m):
    """Every level within NM_TOL; two calls and a CUDA-graph replay of
    the call give the same bits."""
    from chip_smoke import nested_close

    from repro_torch.kernels import nested_matmul as nm

    si, so = _odd_specs()
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    w = torch.randn(si.total, so.total, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    x = torch.randn(m, si.total, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    for level in range(1, so.levels + 1):
        xk = x[:, :si.width(level)]
        got = nm.nested_matmul(xk, w, si, so, level)
        again = nm.nested_matmul(xk, w, si, so, level)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = nm.nested_matmul(xk, w, si, so, level)
        graph.replay()
        torch.cuda.synchronize()
        _, ratio = nested_close(got, nm.nested_matmul_plain(
            xk, w, si, so, level), "bfloat16")
        assert ratio <= 1.0, (level, ratio)
        assert torch.equal(got, again) and torch.equal(got, replayed), level


@pytest.mark.parametrize("geometry", [0, 1, 2],
                         ids=["d->d", "d->d_ff", "d_ff->d"])
def test_nested_matmul_v3_deterministic_at_served_shapes(cuda_device,
                                                         geometry):
    """At the model's geometries, every level and M in {4, 32} (the
    split plans of 1 to 16 blocks a tile): two calls are bitwise equal,
    and so is a replay of a CUDA graph of the call; the kernel that runs
    is v3, one launch a call, its grid the split plan's."""
    from chip_smoke import captured_kernels

    from repro_torch.kernels import nested_matmul as nm

    _, si, so = _full_width_geometries()[geometry]
    gen = torch.Generator(device=cuda_device).manual_seed(10 + geometry)
    w = torch.randn(si.total, so.total, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    for m in (4, 32):
        x = torch.randn(m, si.total, generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        for level in range(1, so.levels + 1):
            xk = x[:, :si.width(min(level, si.levels))]
            first = nm.nested_matmul(xk, w, si, so, level)
            second = nm.nested_matmul(xk, w, si, so, level)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = nm.nested_matmul(xk, w, si, so, level)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(first, second), (m, level)
            assert torch.equal(first, replayed), (m, level)
            splits, m_tiles, n_tiles = nm.nested_split_plan(
                m, so.width(level), xk.shape[1], nm.sm_count(cuda_device))
            launched = captured_kernels(
                lambda: nm.nested_matmul(xk, w, si, so, level))
            assert len(launched) == 1 and "nested_matmul_v3" in \
                launched[0][0], launched
            assert launched[0][1] == (splits, n_tiles, m_tiles)


# --------------------------------------------------------------------- #
# the serving engine's CUDA graphs                                        #
# --------------------------------------------------------------------- #
ENGINE_CASES = ["blocks-ref", "kernel-ref", "blocks-kernel", "kernel-kernel",
                "rwkv", "qwen2.5-14b", "gemma3-1b", "olmoe-1b-7b",
                "qwen3-moe-30b-a3b", "olmoe-1b-7b-gather", "jamba-v0.1-52b",
                "qwen2-vl-2b"]


def _serve_engine(cuda_device, case, max_len=12):
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import init_lm
    from repro_torch.serving.engine import ServeEngine

    if case == "rwkv":
        from repro_torch.configs.rwkv6_3b import reduced

        cfg = reduced()
    elif case == "olmoe-1b-7b-gather":
        from repro_torch.configs import get_reduced

        cfg = get_reduced("olmoe-1b-7b").replace(attn_backend="kernel",
                                                 moe_dispatch="gather")
    elif case in ("qwen2.5-14b", "gemma3-1b", "olmoe-1b-7b",
                  "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "qwen2-vl-2b"):
        from repro_torch.configs import get_reduced

        cfg = get_reduced(case).replace(attn_backend="kernel")
    else:
        from repro_torch.configs.alert_anytime import reduced

        nest, attn = case.split("-")
        cfg = reduced().replace(nest_backend=nest, attn_backend=attn)
    params = init_lm(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                     device=cuda_device)
    return ServeEngine(build_model(cfg), max_len=max_len, batch_size=4,
                       device=cuda_device), params


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_graphed_engine_matches_eager(cuda_device, case):
    """Graphed tokens bitwise equal to the eager engine's at every level
    over three rounds of level switches; ``n_compiles()`` is (levels,
    levels) after the warm-up and stays so; each replay adds to every
    launch counter what the eager call adds, and what its graph's kernel
    nodes say (``chip_smoke.engine_graphs_vs_eager``)."""
    from chip_smoke import engine_graphs_vs_eager

    eng, params = _serve_engine(cuda_device, case)
    out = engine_graphs_vs_eager(eng, params, 8, 4)
    n = len(eng.levels)
    assert out["n_compiles"] == [n, n]


def test_engine_compiles_once_per_level_and_prompt_shape(cuda_device):
    """Two prompt lengths: (levels x 2, levels) graphs after the warm-ups,
    flat over three rounds of level and length switches, and no capture
    counted as a launch."""
    from repro_torch.kernels import nested_matmul as nm

    eng, params = _serve_engine(cuda_device, "kernel-kernel", max_len=16)
    n = len(eng.levels)
    eng.warmup(params, 8)
    eng.warmup(params, 5)
    assert eng.n_compiles() == (2 * n, n)
    rng = np.random.default_rng(0)
    for _ in range(3):
        for level in reversed(eng.levels):
            for s0 in (5, 8):
                prompt = rng.integers(0, eng.model.cfg.vocab, (4, s0))
                before = nm.nested_matmul.launches
                eng.generate(params, prompt.astype(np.int32), 3, level=level)
                assert nm.nested_matmul.launches - before == \
                    3 * 7 * eng.model.cfg.n_layers
    assert eng.n_compiles() == (2 * n, n)


def test_engine_records_graph_captures_and_replays(cuda_device):
    """With a recorder: one ``graph_captures`` count and one
    ``graph_capture`` event a graph made (a new prompt length captures
    prefill graphs only); a generate's ``step`` spans are graphed."""
    from repro_torch.obs import FlightRecorder

    eng, params = _serve_engine(cuda_device, "kernel-kernel", max_len=16)
    eng.obs = obs = FlightRecorder()
    n = len(eng.levels)
    eng.warmup(params, 8)
    assert obs.metrics.counter("graph_captures").value == 2 * n
    eng.warmup(params, 5)
    eng.generate(params, np.zeros((4, 5), np.int32), 3, level=eng.levels[0])
    assert obs.metrics.counter("graph_captures").value == 3 * n
    caps = [e["args"] for e in obs.spans.events
            if e["name"] == "graph_capture"]
    assert sorted((c["stage"], c["prompt_len"]) for c in caps) == sorted(
        [("prefill", 8)] * n + [("decode", 8)] * n + [("prefill", 5)] * n)
    steps = [e["args"] for e in obs.spans.events if e["name"] == "step"]
    assert [s["stage"] for s in steps] == ["prefill", "decode", "decode"]
    assert all(s["graphed"] for s in steps)


def test_graphed_decode_leaves_no_trace_between_requests(cuda_device):
    """A long request, then a short one: the short one's tokens equal a
    fresh graphed engine's."""
    used, params = _serve_engine(cuda_device, "kernel-kernel", max_len=16)
    fresh, _ = _serve_engine(cuda_device, "kernel-kernel", max_len=16)
    rng = np.random.default_rng(1)
    vocab = used.model.cfg.vocab
    long_p = rng.integers(0, vocab, (4, 10)).astype(np.int32)
    short_p = rng.integers(0, vocab, (4, 4)).astype(np.int32)
    for level in used.levels:
        used.generate(params, long_p, 6, level=level)
        got = used.generate(params, short_p, 4, level=level)["tokens"]
        want = fresh.generate(params, short_p, 4, level=level)["tokens"]
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------- #
# alert_select: CUDA's erf against torch's, over the Eq. 7 range          #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("paper_faithful", [True, False])
def test_alert_select_erf_sweep_is_bitwise(cuda_device, paper_faithful):
    """Lanes whose Eq. 7 argument ``z / sqrt2`` at one cell sweeps
    [-6, 6] in steps of 1.8e-4 (erf is +-1 to the last bit beyond), the
    other cells at other ``z``: the kernel (its ``alert_erf`` /
    ``alert_exp``) and the plain version (the module's ``erf`` / ``exp``)
    on the card, and the plain version on the CPU, give the same picks,
    feasibility, relax codes and predictions, bit for bit."""
    eng = _engine(cuda_device, paper_faithful)
    s = 65536
    lat0 = float(eng.table.latency[3, 5])
    arg = np.linspace(-6.0, 6.0, s)                 # z / sqrt2 at (3, 5)
    sd = np.where(np.arange(s) % 2, 0.05, 0.2)
    mu = np.ones(s)
    deadline = eng.overhead + mu * lat0 + np.sqrt(2.0) * arg * sd * lat0
    rng = np.random.default_rng(0)
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                    device=cuda_device)
    goal_kind = torch.as_tensor((np.arange(s) % 3 == 0).astype(np.int32),
                                device=cuda_device)
    args = [f64(mu), f64(sd), f64(rng.uniform(0.05, 0.8, s)),
            f64(np.maximum(deadline, 1e-6)), f64(rng.uniform(0.3, 1.0, s)),
            f64(rng.uniform(0.1, 3.0, s) * lat0 * 200.0), goal_kind,
            torch.ones(s, dtype=torch.int32, device=cuda_device)]
    kw = _consts(eng, paper_faithful_energy=paper_faithful, predictions=True)
    got = ks.alert_select(*args, **kw)
    torch.cuda.synchronize()
    cpu_kw = {k: v.cpu() if isinstance(v, torch.Tensor) else v
              for k, v in kw.items()}
    names = ("model_index", "power_index", "predicted_latency",
             "predicted_accuracy", "predicted_energy", "feasible",
             "relaxed_code")
    for where, want in (
            ("the card", ks.alert_select_plain(*args, **kw)),
            ("the CPU", ks.alert_select_plain(*[a.cpu() for a in args],
                                              **cpu_kw))):
        for name, a, b in zip(names, got, want):
            a = a.cpu()
            b = b.cpu()
            if not torch.equal(a, b):
                bad = torch.nonzero(a != b).flatten()[:8].tolist()
                ulp = ""
                if a.dtype == torch.float64:
                    gap = (a.view(torch.int64) - b.view(torch.int64)).abs()
                    ulp = f", worst {int(gap.max())} ulp"
                pytest.fail(f"{name} differs from the plain version on "
                            f"{where} on {int((a != b).sum())} lanes "
                            f"(first {bad}{ulp})")


@pytest.mark.parametrize("fn,lo,hi", [("erf", -8.0, 8.0),
                                      ("exp", -745.5, 5.0)])
def test_port_erf_exp_bitwise_cpu_and_card(cuda_device, fn, lo, hi):
    """The module's ``erf`` at 200,001 points of [-8, 8] and ``exp`` over
    [-745.5, 5] (the range the plain version feeds it): the CPU and the
    card give the same bits at every point (float64 ``torch.erf`` does
    not)."""
    f = getattr(ks, fn)
    x = torch.linspace(lo, hi, 200_001, dtype=torch.float64)
    a = f(x)
    b = f(x.to(cuda_device)).cpu()
    differ = int((a.view(torch.int64) != b.view(torch.int64)).sum())
    assert differ == 0, f"{differ} points differ"



# --------------------------------------------------------------------- #
# alert_select v2: table sizes, ties, signed zeros, NaN and dead lanes    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("table", list(range(5)))
def test_alert_select_v2_edge_cases_bitwise(cuda_device, table):
    """chip_smoke.select_cases at one of its K x L tables (1x1, 4x4, 5x7,
    12x8, 32x4): S of 1, 7, 257 and 4097 lanes, tied scores, +0.0 and
    -0.0 scores, NaN lanes and cells, dead lanes, both energy modes,
    predictions on and off; every output bitwise equal to the plain
    version's."""
    from chip_smoke import SELECT_TABLES, select_cases

    before = ks.alert_select.launches
    n = select_cases(cuda_device, tables=(SELECT_TABLES[table],))
    assert ks.alert_select.launches == before + n


def test_alert_select_v2_packed_views_keep_their_dtypes(cuda_device):
    """The 7-tuple is views of the two packed buffers, in the dtypes it
    always had; the engine's select reads the same values back; the
    library's limits are the module's."""
    eng = _engine(cuda_device)
    args = fleet_inputs(eng.table, 1000, seed=3, device=cuda_device)
    kw = _consts(eng)
    ints, f64 = ks.alert_select_packed(*args, **kw)
    out = ks.alert_select(*args, **kw)
    torch.cuda.synchronize()
    assert [o.dtype for o in out] == [torch.int32, torch.int32] + \
        [torch.float64] * 3 + [torch.bool, torch.int32]
    for o in out:
        assert o.shape == (1000,) and o.device == cuda_device
    ptrs = {o.untyped_storage().data_ptr() for o in out}
    assert len(ptrs) == 2
    assert torch.equal(out[5], ints[2] != 0)
    for a, b in zip(ks.unpack(ints, f64), out):
        assert torch.equal(a, b)
    batch = eng.select(*[a.cpu().numpy() for a in args[:4]],
                       accuracy_goal=args[4].cpu().numpy(),
                       energy_goal=args[5].cpu().numpy(),
                       goal_kind=args[6].cpu().numpy(),
                       active=args[7].cpu().numpy() != 0)
    np.testing.assert_array_equal(batch.model_index, out[0].cpu().numpy())
    np.testing.assert_array_equal(batch.feasible, out[5].cpu().numpy())
    np.testing.assert_array_equal(batch.predicted_energy,
                                  out[4].cpu().numpy())
    lib = ks._library()
    assert (lib.alert_select_max_k(), lib.alert_select_max_kl()) == \
        (ks.MAX_K, ks.MAX_KL)


# --------------------------------------------------------------------- #
# rwkv_scan v3: the sequence split                                       #
# --------------------------------------------------------------------- #
RWKV_SPLIT = {  # (b, s, h, hd, strided)
    "ragged-hd64-strided": (2, 77, 3, 64, True),
    "ragged-hd16": (2, 77, 3, 16, False),
    "ragged-hd32": (3, 45, 2, 32, False),
    "shorter-than-segments": (1, 5, 2, 32, False),
}


@pytest.mark.parametrize("segments", [1, 2, 3, 7])
@pytest.mark.parametrize("case", list(RWKV_SPLIT))
def test_rwkv_scan_v3_forced_plans_match_both_plain_versions(
        cuda_device, monkeypatch, case, segments):
    """The kernel under a monkeypatched plan against rwkv_scan_plain
    (RS_TOL, as chip_smoke.rwkv_case checks it) and against
    rwkv_scan_segments_plain at the same segments (the same tolerance), in
    float32 and bf16."""
    from chip_smoke import RS_TOL, rwkv_close, rwkv_inputs
    from repro_torch.kernels import rwkv_scan as rs

    b, s, h, hd, strided = RWKV_SPLIT[case]
    monkeypatch.setattr(rs, "rwkv_scan_plan", lambda *shape: segments)
    gen = torch.Generator(device=cuda_device).manual_seed(segments)
    x = rwkv_inputs(gen, b, s, h, hd, cuda_device, strided=strided)
    scale_y, scale_s = rs.rwkv_scan_plain(*[t.abs() for t in x])
    for dt in RS_TOL:
        xd = [t.to(getattr(torch, dt)) for t in x[:4]] + x[4:]
        got_y, got_s = rs.rwkv_scan(*xd)
        torch.cuda.synchronize()
        for want_y, want_s in (rs.rwkv_scan_plain(*xd),
                               rs.rwkv_scan_segments_plain(*xd, segments)):
            rwkv_close(got_y, want_y, scale_y, dt, f"{case} {dt} y")
            rwkv_close(got_s, want_s, scale_s, "float32",
                       f"{case} {dt} state")


@pytest.mark.parametrize("segments", [None, 1, 2, 5])
def test_rwkv_scan_v3_is_deterministic_and_launches_the_plan(
        cuda_device, monkeypatch, segments):
    """Two identical calls give the same bits; a CUDA graph of one call
    holds the plan's kernels (chip_smoke.rwkv_launched); the counter goes
    up by one a call, whatever the segments.  ``None``: the plan's own
    split at a 600-token prompt of B=4 and 40 heads."""
    from chip_smoke import rwkv_inputs, rwkv_launched
    from repro_torch.kernels import rwkv_scan as rs
    from repro_torch.kernels.checks import sm_count

    b, s, h, hd = 4, 600, 40, 64
    plan = rs.rwkv_scan_plan(b, s, h, sm_count(cuda_device))
    if segments is not None:
        monkeypatch.setattr(rs, "rwkv_scan_plan", lambda *shape: segments)
        plan = segments
    else:
        assert plan > 1
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = rwkv_inputs(gen, b, s, h, hd, cuda_device)
    before = rs.rwkv_scan.launches
    first = rs.rwkv_scan(*x)
    second = rs.rwkv_scan(*x)
    torch.cuda.synchronize()
    assert rs.rwkv_scan.launches == before + 2
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    got = rwkv_launched("test", b, s, h, plan, lambda: rs.rwkv_scan(*x))
    assert got["cuda_launches"] == (1 if plan == 1 else 3)
    assert got["segments"] == plan


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_rwkv_scan_decode_step_runs_its_own_kernel(cuda_device, hd):
    """A one-token call (the served decode step, B=4, 40 heads) launches
    rwkv_scan_decode alone, within RS_TOL of rwkv_scan_plain in float32
    and bf16, and bitwise equal across two calls."""
    from chip_smoke import RS_TOL, rwkv_close, rwkv_inputs, rwkv_launched
    from repro_torch.kernels import rwkv_scan as rs

    b, h = 4, 40
    gen = torch.Generator(device=cuda_device).manual_seed(hd)
    x = rwkv_inputs(gen, b, 1, h, hd, cuda_device)
    scale_y, scale_s = rs.rwkv_scan_plain(*[t.abs() for t in x])
    for dt in RS_TOL:
        xd = [t.to(getattr(torch, dt)) for t in x[:4]] + x[4:]
        got_y, got_s = rs.rwkv_scan(*xd)
        again = rs.rwkv_scan(*xd)
        torch.cuda.synchronize()
        assert torch.equal(got_y, again[0]) and torch.equal(got_s, again[1])
        want_y, want_s = rs.rwkv_scan_plain(*xd)
        rwkv_close(got_y, want_y, scale_y, dt, f"decode {dt} y")
        rwkv_close(got_s, want_s, scale_s, "float32", f"decode {dt} state")
        got = rwkv_launched("decode", b, 1, h, 1, lambda: rs.rwkv_scan(*xd))
        assert got == {"segments": 1, "cuda_launches": 1}


@pytest.mark.parametrize("segments", [1, 3])
@pytest.mark.parametrize("s", [1, 77])
def test_rwkv_scan_takes_unaligned_u_and_s0_views(cuda_device, monkeypatch,
                                                  s, segments):
    """u and s0 as contiguous views 4 bytes past a 16-byte boundary: the
    wrapper copies s0 to an aligned buffer for the tile's 16-byte loads,
    so the result equals that of aligned copies of the same values."""
    from chip_smoke import rwkv_inputs
    from repro_torch.kernels import rwkv_scan as rs

    monkeypatch.setattr(rs, "rwkv_scan_plan", lambda *shape: segments)
    b, h, hd = 2, 3, 64
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    r, k, v, w, u, s0 = rwkv_inputs(gen, b, s, h, hd, cuda_device)
    u_off = torch.empty(u.numel() + 1, device=cuda_device)[1:].view_as(u)
    s0_off = torch.empty(s0.numel() + 1, device=cuda_device)[1:].view_as(s0)
    u_off.copy_(u)
    s0_off.copy_(s0)
    assert u_off.data_ptr() % 16 and s0_off.data_ptr() % 16
    assert u_off.is_contiguous() and s0_off.is_contiguous()
    got = rs.rwkv_scan(r, k, v, w, u_off, s0_off)
    want = rs.rwkv_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, want))


# --------------------------------------------------------------------- #
# The fleet simulator on the card                                        #
# --------------------------------------------------------------------- #
def test_churning_fleet_on_card_equals_cpu(cuda_device):
    """64 churning streams of both goals (phase 30's tenants): every
    FleetResult array bitwise equal to the CPU port's run."""
    from repro_torch.serving.scenarios import fleet_specs, golden_table
    from repro_torch.serving.sim import run_fleet

    table = golden_table()
    specs = fleet_specs(table, 64)
    got = run_fleet(table, specs, device=cuda_device)
    want = run_fleet(table, specs, device="cpu")
    for f in ("energy", "accuracy", "latency", "missed", "budget",
              "active"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("env", ["default", "cpu", "memory"])
def test_fleet_on_card_reproduces_golden_traces(cuda_device, env):
    """``tests/golden_traces.json``'s alert entries with ``==`` on the
    CUDA ``alert_select``, the table rebuilt by ``golden_table()``."""
    import json
    import os

    from repro_torch.core.controller import Constraints, Goal
    from repro_torch.serving.scenarios import golden_deadline, golden_table
    from repro_torch.serving.sim import ENVS, EnvironmentTrace, FleetSim

    with open(os.path.join(os.path.dirname(__file__),
                           "golden_traces.json")) as f:
        golden = json.load(f)
    table = golden_table()
    cons = Constraints.from_power_budget(
        float(golden_deadline(table, 3)[1]), golden["budget_w"])
    fleet = FleetSim(table, [EnvironmentTrace(ENVS[env],
                                              seed=golden["seed"])],
                     device=cuda_device)
    res = fleet.run_alert(Goal.MAXIMIZE_ACCURACY, cons)
    assert fleet.engine.backend == "cuda"
    assert {k: getattr(res, k) for k in golden["envs"][env]["alert"]} == \
        golden["envs"][env]["alert"]


def test_deliver_step_on_card_equals_deliver_tick(cuda_device):
    from repro_torch.serving.scenarios import golden_table
    from repro_torch.serving.sim import DeliveredTick, deliver_step, \
        deliver_tick

    table = golden_table()
    st = table.staircase_tensors()
    k, l = table.latency.shape
    is_any = np.zeros(k, bool)
    for g in table.anytime_groups().values():
        is_any[g] = True
    rng = np.random.default_rng(4)
    s = 65536
    i, j = rng.integers(0, k, s), rng.integers(0, l, s)
    scale = rng.uniform(0.5, 3.0, s)
    dvec = rng.uniform(0.01, 2.0 * float(table.latency.max()), s)
    want = deliver_tick(table, st, i, j, scale, dvec, 0.25, is_any,
                        table.latency[i, j])
    got = deliver_step(*(torch.as_tensor(x, device=cuda_device)
                         for x in (i, j, scale, dvec)), 0.25,
                       latency_kl=table.latency,
                       run_power_kl=table.run_power, q_fail=table.q_fail,
                       is_anytime_k=is_any, lvl_lat_kml=st.lvl_lat,
                       lvl_valid_km=st.lvl_valid, lvl_acc_km=st.lvl_acc)
    for f, g in zip(DeliveredTick.__dataclass_fields__, got):
        assert g.device.type == "cuda"
        assert np.array_equal(g.cpu().numpy(), getattr(want, f)), f


def test_fleet_launches_alert_select_once_per_tick(cuda_device):
    from repro_torch.core.controller import Constraints, Goal
    from repro_torch.serving.scenarios import golden_deadline, golden_table
    from repro_torch.serving.sim import ENVS, FleetSim

    table = golden_table()
    fleet = FleetSim.from_phases(table, ENVS["cpu"], 8, seed=3,
                                 length_cv=0.1, device=cuda_device)
    cons = Constraints(deadline=float(golden_deadline(table, 3)[1]),
                       accuracy_goal=0.8)
    before = ks.alert_select.launches
    fleet.run_alert(Goal.MINIMIZE_ENERGY, cons)
    assert ks.alert_select.launches - before == fleet.n_ticks


# --------------------------------------------------------------------- #
# The session gateway on the card                                        #
# --------------------------------------------------------------------- #
def test_gateway_on_card_reproduces_golden(cuda_device):
    """``tests/golden_traces.json``'s ``gateway`` summary with ``==`` on
    the CUDA ``alert_select``, one launch a served round."""
    import json
    import os

    from repro_torch.serving.scenarios import (gateway_summary,
                                               golden_gateway_workload,
                                               golden_table)
    from repro_torch.traffic import SessionGateway, generate_requests

    with open(os.path.join(os.path.dirname(__file__),
                           "golden_traces.json")) as f:
        want = json.load(f)["gateway"]
    table = golden_table()
    sessions, n_lanes, dl = golden_gateway_workload(table)
    gw = SessionGateway(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                        device=cuda_device)
    before = ks.alert_select.launches
    res = gw.run(sessions, generate_requests(sessions))
    assert gw.engine.backend == "cuda"
    assert gateway_summary(res) == want
    assert res.select_launches == res.n_rounds == \
        ks.alert_select.launches - before


def test_gateway_on_card_reproduces_straggler_golden(cuda_device):
    import json
    import os

    from repro_torch.serving.scenarios import (golden_table,
                                               straggler_workload)
    from repro_torch.traffic import (KalmanLaneDetector, SessionGateway,
                                     generate_requests)

    with open(os.path.join(os.path.dirname(__file__),
                           "golden_traces.json")) as f:
        g = json.load(f)["straggler"]
    table = golden_table()
    sessions, n_lanes, dl, faults = straggler_workload(table)
    det = KalmanLaneDetector(n_lanes)
    SessionGateway(table, n_lanes, tick=dl, device=cuda_device).run(
        sessions, generate_requests(sessions), faults=faults, detector=det)
    lane = g["fault_lane"]
    assert [int(x) for x in np.nonzero(det.tripped)[0]] == g["tripped_lanes"]
    assert float(det.first_trip_time[lane]) == g["first_trip_time_s"]
    assert det.detection_latency(lane, g["fault_start_rounds"] * dl) / dl \
        == g["detection_latency_rounds"]


def _gateway_overload(table):
    """64 Eq. 4 sessions at ~8x the capacity of 16 lanes, tick T_goal/4."""
    from repro_torch.serving.scenarios import traffic_mix
    from repro_torch.traffic import build_sessions

    mix, dl, _ = traffic_mix(table, 64, 16, 8.0)
    return build_sessions(mix, 10 * dl, seed=11), dl


@pytest.mark.parametrize("policy", ["alert", "static"])
def test_gateway_overload_on_card_follows_cpu(cuda_device, policy):
    """The card's run, every select held bitwise to the plain version on
    the card (``chip_smoke.held_run``), against the CPU port's
    (``chip_smoke.hold_to_cpu``): with the card's decisions injected the
    CPU run is bitwise equal, and each pick the CPU's plain version makes
    otherwise follows the pick contract; ``alert_select`` once a served
    round under the controller, never under a fixed config."""
    from chip_smoke import held_run, hold_to_cpu
    from repro_torch.serving.scenarios import golden_table
    from repro_torch.traffic import SessionGateway, generate_requests

    table = golden_table()
    sessions, dl = _gateway_overload(table)
    kw = dict(policy=policy,
              static_config=(2, 3) if policy == "static" else None)

    def make(dev):
        return SessionGateway(table, 16, tick=dl / 4, max_queue=64,
                              device=dev)

    def run(gw):
        return gw.run(sessions, generate_requests(sessions), **kw)

    got, log = held_run(make(cuda_device), run, [])
    assert got.reject_rate > 0.05 and got.pages_in > 0
    out = hold_to_cpu(make, run, got, log, f"overload {policy}")
    assert out["selects"] == (got.n_rounds if policy == "alert" else 0)
    if policy == "static":
        assert out["bitwise"]
    assert got.select_launches == (got.n_rounds if policy == "alert" else 0)


def test_gateway_kill_resume_on_card_is_bitwise(cuda_device, tmp_path):
    from repro_torch.runtime.ft import InjectedFailure
    from repro_torch.serving.scenarios import golden_table
    from repro_torch.traffic import (SessionGateway, generate_requests,
                                     scenario)

    table = golden_table()
    sessions, dl = _gateway_overload(table)
    fs = scenario("brownout", 16, start=3 * dl, horizon=10 * dl, seed=11)

    def gw():
        return SessionGateway(table, 16, tick=dl / 4, max_queue=64,
                              device=cuda_device)

    want = gw().run(sessions, generate_requests(sessions), faults=fs)
    ck = str(tmp_path / "ck")
    with pytest.raises(InjectedFailure):
        gw().run(sessions, generate_requests(sessions), faults=fs,
                 checkpoint_dir=ck, checkpoint_every=5, kill_at_round=17)
    got = gw().resume(sessions, generate_requests(sessions),
                      checkpoint_dir=ck, faults=fs)
    for f in ("status", "start", "latency", "sojourn", "missed", "accuracy",
              "energy", "model_index", "power_index"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert (got.n_rounds, got.pages_in, got.pages_out, got.horizon) == \
        (want.n_rounds, want.pages_in, want.pages_out, want.horizon)


# --------------------------------------------------------------------- #
# The megatick: a graphed chunk against the eager one and the CPU         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["alert", "static"])
def test_megatick_graph_equals_eager_and_cpu(cuda_device, policy):
    """The gateway golden's workload through the megatick on the card: the
    replayed CUDA graph (chunks of 4 rounds: three replays, no pad round),
    the same chunk run eagerly with ``graphs=False``, and the CPU give
    bitwise equal results; one graph a policy, one ``alert_select``
    launch a served round under ``alert``."""
    from repro_torch.serving.scenarios import (golden_gateway_workload,
                                               golden_table)
    from repro_torch.traffic import MegatickGateway, generate_requests

    table = golden_table()
    sessions, n_lanes, dl = golden_gateway_workload(table)
    kw = dict(policy="static", static_config=(2, 3)) \
        if policy == "static" else {}
    res = {}
    for name, dev, graphs in (("graph", cuda_device, True),
                              ("eager", cuda_device, False),
                              ("cpu", torch.device("cpu"), True)):
        gw = MegatickGateway(table, n_lanes, tick=dl, max_queue=4 * n_lanes,
                             chunk=4, device=dev, graphs=graphs)
        res[name] = gw.run(sessions, generate_requests(sessions), **kw)
        assert gw.n_compiles() == (0, 1)
        assert len(gw.chunk_graphs()) == (name == "graph")
    want = res["graph"].n_rounds if policy == "alert" else 0
    assert res["graph"].select_launches == res["eager"].select_launches \
        == want and res["cpu"].select_launches == 0
    fields = ("status", "start", "latency", "sojourn", "missed", "accuracy",
              "energy", "model_index", "power_index")
    for name in ("eager", "cpu"):
        for f in fields:
            np.testing.assert_array_equal(getattr(res[name], f),
                                          getattr(res["graph"], f),
                                          err_msg=f"{name} {f}")
        assert (res[name].n_rounds, res[name].pages_in,
                res[name].pages_out) == (res["graph"].n_rounds,
                                         res["graph"].pages_in,
                                         res["graph"].pages_out)


# --------------------------------------------------------------------- #
# training (phase 33's parts)                                            #
# --------------------------------------------------------------------- #
def _guarded_calls(device):
    from repro_torch.core.nesting import StripeSpec
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import nested_matmul as nm
    from repro_torch.kernels import rwkv_scan as rs

    spec = StripeSpec.pow2(64, 2)
    g = torch.Generator(device=device).manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g, device=device)
    q, k, v = r(2, 4, 2, 16), r(2, 4, 2, 16), r(2, 4, 2, 16)
    return [
        (nm.nested_matmul, lambda x, w: nm.nested_matmul(x, w, spec, spec),
         (r(4, 64), r(64, 64))),
        (fa.flash_attention, lambda q, k, v: fa.flash_attention(q, k, v),
         (q, k, v)),
        (da.decode_attention, lambda q, k, v: da.decode_attention(
            q[:, 0], k, v, 3), (q, k, v)),
        (rs.rwkv_scan, rs.rwkv_scan,
         (r(1, 3, 2, 16), r(1, 3, 2, 16), r(1, 3, 2, 16),
          torch.rand(1, 3, 2, 16, generator=g, device=device), r(2, 16),
          r(1, 2, 16, 16)))]


def test_kernel_wrappers_refuse_gradients_on_the_card(cuda_device):
    """On CUDA tensors a wrapper launches into ``torch.empty``, whose
    output has no ``grad_fn``: with any floating input requiring a
    gradient it raises before launching, and without one it launches."""
    for wrapper, call, args in _guarded_calls(cuda_device):
        name = wrapper.__name__
        before = wrapper.launches
        for i in range(len(args)):
            live = [a.clone().requires_grad_(j == i)
                    for j, a in enumerate(args)]
            with pytest.raises(RuntimeError, match=f"{name} has no "
                                                   f"backward"):
                call(*live)
        assert wrapper.launches == before
        with torch.no_grad():
            call(*[a.clone().requires_grad_(True) for a in args])
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1


def test_reduced_train_steps_on_the_card_match_the_cpu(cuda_device):
    from chip_smoke import train_cpu_vs_card

    out = train_cpu_vs_card(cuda_device, archs=("alert-anytime-120m",
                                                "olmoe-1b-7b", "rwkv6-3b"))
    assert out["alert-anytime-120m"]["elements"] > 0
    assert out["olmoe-1b-7b"]["route_calls"] > 0
    assert out["rwkv6-3b"]["elements"] > 0      # the chunk scan trains
    assert all(o["grads"]["worst_ratio"] <= 1.0 for o in out.values())


def test_reduced_rwkv_trains_then_serves_on_the_card(cuda_device):
    """Phase 34 at the reduced size: the chunk scan trains (no
    ``rwkv_scan`` launch), then the graphed prefill on ``rwkv_scan``
    holds to ``train_logits`` and the fleet server launches it."""
    from chip_smoke import RWKV_SERVE_ULPS, rwkv_training_phase
    from repro_torch.configs.rwkv6_3b import reduced

    out = rwkv_training_phase(cuda_device, cfg=reduced(), steps=3, seq=40)
    assert out["served_vs_train"]["max_row_ulps"] <= RWKV_SERVE_ULPS
    assert out["serve"]["rwkv_scan_launches"] > 0
    assert out["train"]["losses"][-1] < out["train"]["losses"][0]


def test_cuda_train_state_checkpoint_roundtrip_bitwise(cuda_device,
                                                       tmp_path):
    """A bf16 train state on the card (float32 moments) saved and
    restored onto the card: every bit and dtype back, as a TrainState."""
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.configs.alert_anytime import reduced
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import (TrainState, init_train_state,
                                        make_anytime_loss_fn,
                                        make_train_step)
    from repro_torch.tree import tree_leaves, tree_map

    cfg = reduced()
    model, opt = build_model(cfg), AdamW(lr=8e-3)
    state = init_train_state(model, cfg, opt, device=cuda_device)
    step = make_train_step(model, cfg, opt,
                           loss_fn=make_anytime_loss_fn(model, cfg))
    tok = torch.randint(0, cfg.vocab, (2, 16), device=cuda_device)
    state, _ = step(state, {"tokens": tok, "labels": tok})
    d = str(tmp_path / "ck")
    ckpt_io.save(d, state, step=1)
    like = tree_map(torch.zeros_like, state)
    got, n = ckpt_io.restore(d, like)
    assert n == 1 and type(got) is TrainState
    for a, b in zip(tree_leaves(got), tree_leaves(state)):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_kill_and_resume_on_the_card_is_bitwise(cuda_device):
    from chip_smoke import train_resume

    assert train_resume(cuda_device)["bitwise"]


# --------------------------------------------------------------------- #
# The lane-sharded decision plane on one card                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("lo,hi", [(0, 1025), (1025, 2050), (3, 1000),
                                   (4097, 4101)])
def test_alert_select_on_offset_views(cuda_device, lo, hi):
    """A block of each lane vector (a view with a storage offset, at odd
    offsets too) launches once, bitwise a contiguous copy's result and the
    plain version's."""
    eng = _engine(cuda_device)
    args = fleet_inputs(eng.table, 4101, seed=lo, device=cuda_device)
    kw = _consts(eng)
    views = [x[lo:hi] for x in args]
    assert views[0].storage_offset() == lo
    before = ks.alert_select.launches
    got = ks.alert_select_packed(*views, **kw)
    assert ks.alert_select.launches == before + 1
    want = ks.alert_select_packed(*(x.clone() for x in views), **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = ks.alert_select_plain(*views, **kw)
    for a, b in zip(ks.unpack(*got), plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shards", [1, 4, 8])
def test_sharded_engine_launches_once_a_shard(cuda_device, shards):
    """A mesh of shards on the one card: one launch a shard a select,
    bitwise the unsharded engine on the card and the CPU's."""
    from repro_torch.launch.mesh import make_lane_mesh

    s = 8 * 1031
    rng = np.random.default_rng(shards)
    table = synthetic_table(0)
    host = dict(mu=rng.uniform(0.5, 3.0, s), sigma=rng.uniform(0.01, 0.5, s),
                phi=rng.uniform(0.05, 0.8, s),
                deadline=rng.uniform(0.1, 3.0, s)
                * float(np.median(table.latency)))
    kw = dict(accuracy_goal=rng.uniform(0.2, 1.1, s),
              energy_goal=rng.uniform(0.0, 50.0, s),
              goal_kind=rng.integers(0, 2, s), active=rng.random(s) < 0.9)
    mesh = make_lane_mesh(shards, device=cuda_device)
    eng = BatchedAlertEngine(table, None, overhead=0.001, mesh=mesh)
    before = ks.alert_select.launches
    got = eng.select(*host.values(), **kw)
    assert ks.alert_select.launches == before + shards
    for dev in ("cuda", "cpu"):
        want = BatchedAlertEngine(table, None, overhead=0.001,
                                  device=dev).select(*host.values(), **kw)
        for f in ("model_index", "power_index", "predicted_latency",
                  "predicted_accuracy", "predicted_energy", "feasible",
                  "relaxed_code"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_sharded_banks_on_card_equal_cpu(cuda_device):
    from repro_torch.core.kalman import (IdlePowerFilterBank,
                                         SlowdownFilterBank, observe_fleet)
    from repro_torch.launch.mesh import make_lane_mesh

    s = 4096
    rng = np.random.default_rng(0)
    mesh = make_lane_mesh(4, device=cuda_device)
    card = SlowdownFilterBank(s, mesh=mesh), IdlePowerFilterBank(s, mesh=mesh)
    cpu = (SlowdownFilterBank(s, device="cpu"),
           IdlePowerFilterBank(s, device="cpu"))
    for t in range(5):
        obs, prof = rng.uniform(0.01, 1.0, s), rng.uniform(0.01, 1.0, s)
        miss, m = rng.random(s) < 0.2, rng.random(s) < 0.9
        ip, ap = rng.uniform(10, 50, s), rng.uniform(60, 200, s)
        for slow, idle in (card, cpu):
            observe_fleet(slow, idle, obs, prof, deadline_missed=miss,
                          idle_power=ip, active_power=ap, mask=m)
            if t == 2:
                slow.reset_lanes([3, 1500, 4095])
    assert [p.device for p in card[0].mu.parts] == [mesh.home] * 4
    for a, b in zip(card, cpu):
        for name in a._state_names + ("n_updates",):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name))


# --------------------------------------------------------------------- #
# The data plane's (data, model) grid on the card                        #
# --------------------------------------------------------------------- #
def test_grid_of_cuda_shards_never_places_on_the_cpu(cuda_device):
    """Placing a host array, a CPU tensor or a CPU grid's value on a grid
    of CUDA shards puts every block on the card; joining gives it back."""
    from repro_torch.launch.mesh import GridPlacement, make_host_mesh

    mesh = make_host_mesh(2, devices=[cuda_device] * 4)
    cpu_grid = make_host_mesh(2, devices=["cpu"] * 8)
    x = torch.arange(7 * 6, dtype=torch.float32).reshape(7, 6)
    for src in (x.numpy(), x, GridPlacement(cpu_grid, ("data", "model"))
                .place(x)):
        g = GridPlacement(mesh, ("data", "model")).place(src)
        assert all(p.device == cuda_device for p in g.parts.flat)
        assert torch.equal(g.full().cpu(), x)
        assert g.full().device == cuda_device


def test_production_mesh_refuses_one_card(cuda_device):
    from repro_torch.launch.mesh import make_production_mesh

    if torch.cuda.device_count() >= 256:
        pytest.skip("this machine has a production grid's cards")
    with pytest.raises(RuntimeError, match="needs 256 CUDA devices"):
        make_production_mesh()


def test_grid_step_on_the_card_equals_microbatches(cuda_device):
    """The reduced gemma3-1b, float32, three steps on a (2, 2) grid of
    shards on the card under deterministic algorithms: bitwise the
    unsharded ``microbatches=2`` step on the card."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as ts
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.data.synthetic import SyntheticLM

    cfg = get_reduced("gemma3-1b").replace(dtype="float32", vocab=64)
    model, opt = build_model(cfg), AdamW(lr=1e-3)
    state = ts.init_train_state(
        model, cfg, opt, torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    mesh = make_host_mesh(2, devices=[cuda_device] * 4)
    grid = tree_map(lambda leaf, where: where.place(leaf), state,
                    sh.param_shardings(cfg, mesh, state))
    g_step = ts.make_grid_train_step(model, cfg, opt, mesh)
    u_step = ts.make_train_step(model, cfg, opt, microbatches=2)
    data = SyntheticLM(vocab=64, seq_len=32, global_batch=8)
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(3):
            batch = {k: torch.from_numpy(v).to(cuda_device)
                     for k, v in data.batch_at(i).items()}
            grid, gm = g_step(grid, batch)
            state, um = u_step(state, batch)
            assert torch.equal(gm["loss"], um["loss"])
    finally:
        torch.use_deterministic_algorithms(before)
    for a, b in zip(tree_leaves(grid), tree_leaves(state)):
        assert all(p.device == cuda_device for p in a.parts.flat)
        assert torch.equal(a.full(), b)
