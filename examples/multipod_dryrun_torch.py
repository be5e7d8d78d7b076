"""Drive the multi-pod dry runs on the PyTorch/CUDA port (the port of
``examples/multipod_dryrun.py``, on ``repro_torch`` alone): the model
data plane, or the sharded control plane.

    # model dry run, counted on meta over the production grids, one cell:
    PYTHONPATH=src python examples/multipod_dryrun_torch.py \\
        --arch rwkv6-3b --shape long_500k

    # lane-sharded fleet-scoring dry run (8 shards on one device):
    PYTHONPATH=src python examples/multipod_dryrun_torch.py --fleet \\
        [--device cpu]

Both run in process over ``repro_torch.launch`` modules (``dryrun`` /
``fleet_dryrun``): the port needs no faked devices, as ``meta`` tensors
stand in for the 256 (512) devices of the model grids and
``make_lane_mesh(n, device=...)`` lays n lane shards on one device.  The
model mode touches no device; the fleet mode runs on the card unless
given ``--device cpu``, and exits non-zero if sharded picks diverge from
the single-device engine or churn builds anything.
"""

import argparse
import json
import os
import sys
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch import dryrun
from repro_torch.launch.fleet_dryrun import run_fleet_dryrun


def run_fleet(args) -> int:
    """Sharded fleet-scoring dry run (repro_torch.launch.fleet_dryrun)."""
    rec = run_fleet_dryrun(args.streams, args.ticks, args.churn,
                           n_devices=args.devices,
                           device=resolve_device(args.device))
    print(json.dumps(rec, indent=2))
    return 0 if rec["picks_match_single_device"] and \
        rec["builds_flat_under_churn"] else 1


def run_model(args) -> int:
    """Model dry run (repro_torch.launch.dryrun); prints roofline terms
    per cell."""
    with tempfile.TemporaryDirectory() as tmp:
        code = dryrun.main(["--arch", args.arch, "--shape", args.shape,
                            "--mesh", args.mesh, "--out", tmp])
        if code:
            return code
        for name in sorted(os.listdir(tmp)):
            with open(os.path.join(tmp, name)) as f:
                rec = json.load(f)
            print(f"\n== {name}")
            if rec["status"] != "ok":
                print(f"  {rec['status']}: {rec.get('reason', '')}")
                continue
            print(f"  devices={rec['n_devices']} "
                  f"compile={rec['compile_s']}s")
            print(f"  flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e}")
            print(f"  collectives/dev="
                  f"{rec['collective_bytes_per_device']['total']:.3e}B "
                  f"{rec['collective_bytes_per_device']['counts']}")
            mem = rec["memory"]
            print(f"  memory: args={mem['argument_size'] / 1e9:.2f}GB "
                  f"temp={mem['temp_size'] / 1e9:.2f}GB")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--shape", default="long_500k")
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--fleet", action="store_true",
                    help="run the lane-sharded fleet-scoring dry run "
                         "instead of the model dry run")
    ap.add_argument("--devices", type=int, default=8,
                    help="[--fleet] lane shards on the one device")
    ap.add_argument("--streams", type=int, default=4096,
                    help="[--fleet] lane-pool size")
    ap.add_argument("--ticks", type=int, default=12,
                    help="[--fleet] churning fleet ticks to drive")
    ap.add_argument("--churn", type=int, default=64,
                    help="[--fleet] lanes retired and admitted a tick")
    ap.add_argument("--device", default=None,
                    help="[--fleet] cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run_fleet(args) if args.fleet else run_model(args)


if __name__ == "__main__":
    sys.exit(main())
