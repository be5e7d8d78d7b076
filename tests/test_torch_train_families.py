"""The loss and every gradient of ``make_loss_fn`` against
``jax.value_and_grad`` of the reference's for every family but the
anytime LM (``test_torch_train_grads.py``): qwen2.5 (q/k/v biases),
gemma3 (windowed local layers; and ``loss_chunk > 0``, the chunked
cross-entropy from the final hidden states), olmoe (the MoE aux loss; the
one-hot and the gather dispatch),
jamba (Mamba, MoE and attention), qwen2-vl (M-RoPE over three distinct
``pos3d`` streams), whisper-tiny (``encdec_train``) and rwkv6 (the chunk
scan, at 16 tokens, one whole chunk of ``rwkv_chunk``, and at 20, a
padded second chunk), in float32 at the
reduced sizes, from the reference's weights.  The reference runs
``unroll_layers=True``.  Tolerances as in ``test_torch_train_grads.py``:
each gradient leaf within 2e-5 of its largest magnitude, the loss to
rtol 1e-6.
"""

import pytest
import torch

from repro.models.registry import build_model as j_build
from repro.train import step as js
from repro_torch.models.registry import build_model as t_build
from repro_torch.train import step as ts
from tests.test_torch_train_grads import (S, check_value_and_grad,
                                          make_batch, pair)

FAMILIES = [("qwen2.5-14b", {}, False, S),      # q/k/v biases
            ("gemma3-1b", {}, False, S),        # windowed local layers
            ("gemma3-1b", {"loss_chunk": 4}, False, S),
            ("olmoe-1b-7b", {}, False, S),      # the MoE aux loss
            ("olmoe-1b-7b", {"moe_dispatch": "gather"}, False, S),
            ("jamba-v0.1-52b", {}, False, S),   # Mamba, MoE, attention
            ("qwen2-vl-2b", {}, True, S),       # M-RoPE over pos3d
            ("whisper-tiny", {}, False, S),     # encdec_train
            ("rwkv6-3b", {}, False, 16),        # the chunk scan, 1 chunk
            ("rwkv6-3b", {}, False, 20)]        # 2 chunks, the last padded


@pytest.mark.parametrize("arch,kw,pos3d,seq", FAMILIES,
                         ids=[a + "".join(f"-{v}" for v in k.values())
                              + ("" if a != "rwkv6-3b" else f"-S{n}")
                              for a, k, _, n in FAMILIES])
def test_family_loss_and_grads_match(arch, kw, pos3d, seq):
    j_cfg, t_cfg, j_params, t_params = pair(arch, **kw)
    batch = make_batch(t_cfg, pos3d=pos3d, seq=seq)
    t_loss, _ = check_value_and_grad(
        j_cfg, t_cfg, j_params, t_params,
        js.make_loss_fn(j_build(j_cfg), j_cfg),
        ts.make_loss_fn(t_build(t_cfg), t_cfg), batch)
    if arch == "olmoe-1b-7b":   # the aux loss reaches the loss
        _, aux = t_build(t_cfg).train_logits(
            t_params, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(aux) > 0


