"""Quickstart on the PyTorch/CUDA port: build an architecture of the zoo,
train it a few steps, then greedy-decode with the serving engine (the
port of ``examples/quickstart.py``, on ``repro_torch`` alone).

    PYTHONPATH=src python examples/quickstart_torch.py [--arch gemma3-1b] \\
        [--steps 30] [--device cpu]

Uses the reduced config of the chosen arch in float32 over a 64-token
vocabulary.  Training runs the ``blocks`` projections and ``ref``
attention (no kernel has a backward); on a card the decode runs the
kernels (``attn_backend="kernel"``, and ``nest_backend="kernel"`` for a
width-nested model; an RWKV model's recurrence is ``rwkv_scan``) from
CUDA graphs.  Ends with an ``OK`` line once the loss has fallen.
"""

import argparse
import math

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.synthetic import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=configs.ALL_IDS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get_reduced(args.arch).replace(dtype="float32", vocab=64)
    print(f"arch={cfg.name}  layers={cfg.n_layers} d={cfg.d_model} "
          f"plan period={cfg.layer_period()}  params~"
          f"{cfg.param_count() / 1e6:.2f}M (reduced) on {device}")
    model = build_model(cfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=8)
    opt = AdamW(lr=cosine_schedule(5e-3, warmup=5, total=args.steps))
    state = init_train_state(model, cfg, opt,
                             torch.Generator(device=device).manual_seed(0),
                             device=device)
    step = make_train_step(model, cfg, opt)

    losses = []
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in data.batch_at(i).items()}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss={losses[-1]:.3f}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    out = {"device": str(device), "arch": cfg.name, "losses": losses}

    # Greedy-decode a few tokens with the KV-cached serve path.
    if cfg.encoder_layers:
        print("(enc-dec arch: decode demo skipped in quickstart)")
    else:
        serve_cfg = cfg
        if device.type == "cuda":
            serve_cfg = cfg.replace(attn_backend="kernel")
            if cfg.nest_levels > 1:
                serve_cfg = serve_cfg.replace(nest_backend="kernel")
        engine = ServeEngine(build_model(serve_cfg), max_len=64,
                             batch_size=2, device=device)
        prompt = np.asarray(data.batch_at(999)["tokens"][:2, :8])
        r = engine.generate(state.params, prompt, n_new=8)
        print(f"decoded {r['tokens'].shape[1]} tokens in "
              f"{r['latency'] * 1e3:.0f} ms: {r['tokens'][0].tolist()}")
        out["tokens"] = r["tokens"]
    print(f"OK: {cfg.name} trained {args.steps} steps (loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}) and decoded.")
    return out


if __name__ == "__main__":
    main()
