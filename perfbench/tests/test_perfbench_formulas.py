"""The frozen work formulas against hand counts, two shapes a kernel, and
the model-FLOP formulas at a tiny shape."""

from perfbench.reference import nested_dense
from perfbench.roofline import bound_s, flash_attention, nested_matmul


def test_nested_matmul():
    call = dict(m=4, in_bounds=[0, 2, 4], out_bounds=[0, 3, 6], itemsize=2)
    # level 2: live blocks 2x3 + 4x3 = 18; x 4x4, out 4x6
    assert nested_matmul.work(dict(call, level=2)) == (144.0, 116.0)
    # level 1: live 2x3 = 6; x 4x2, out 4x3
    assert nested_matmul.work(dict(call, level=1)) == (48.0, 52.0)


def test_flash_attention():
    # causal 4x4: 10 live pairs; 4*b*h*hd a pair; q, out 2*1*4*2*8, k, v
    assert flash_attention.work(dict(b=1, s=4, t=4, h=2, kv=1, hd=8,
                                     itemsize=2)) == (640.0, 384.0)
    # causal 3x3: 6 pairs
    assert flash_attention.work(dict(b=2, s=3, t=3, h=4, kv=2, hd=16,
                                     itemsize=2)) == (3072.0, 2304.0)


def test_bound_is_the_larger():
    peak = {"flops": 10.0, "bytes": 2.0}
    assert bound_s(100.0, 4.0, peak) == 10.0
    assert bound_s(10.0, 40.0, peak) == 20.0


def test_model_flops():
    cfg = dict(n_layers=1, d_model=8, n_heads=2, n_kv_heads=2, head_dim=4,
               d_ff=16, vocab=10, nest_levels=2)
    # level 1: d 4, heads 1 (q 4, kv 4), d_ff 8.  Live blocks a token:
    # q, k, v 4x4 each, o 4x4, gate, up 4x8 each, down 8x4: 160.
    # One token after 2 cached: 3 live pairs, 4*hd*heads = 16 each.
    assert nested_dense.forward_flops(cfg, 1, 1, 1, 2) == \
        2 * 160 + 16 * 3 + 2 * 4 * 10


def test_model_flops_grouped_heads():
    cfg = dict(n_layers=2, d_model=8, n_heads=4, n_kv_heads=2, head_dim=2,
               d_ff=16, vocab=10, nest_levels=2)
    # level 2: d stripes [4, 8], q [4, 8], kv [2, 4], d_ff [8, 16].
    # Live blocks: q 4x4 + 8x4 = 48, k and v 4x2 + 8x2 = 24 each,
    # o 4x4 + 8x4 = 48, gate and up 4x8 + 8x8 = 96 each, down 8x4 +
    # 16x4 = 96: 432 a token.  A 3-token prefill: 6 causal pairs, 4*8
    # FLOPs each; the unembedding of one position a row, 2*8*10.
    assert nested_dense.forward_flops(cfg, 2, 1, 3, 0) == \
        2 * (3 * 2 * 432 + 32 * 6) + 2 * 8 * 10
