"""Read a cell's compared numbers for the program and for its control on
several seeds, at the cell's own size, in one process: the readings that
the limits of ``correct`` are set from. Not part of a benchmark run. The
control is planted in the program by the kind's ``control(fmt)``
(``portbench/kinds/<kind>.py``), as a fault would be.

    python3 portbench/control.py --workload <name> --seeds 11 12 13 \
        [--seconds 3]

Prints one JSON line a seed and side: {"workload", "seed", "side",
"attempted", "checks"}. Needs a CUDA card.
"""
import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload, ROOT)
    dev = torch.device("cuda", torch.cuda.current_device())
    for seed in args.seeds:
        traffic = harness.make_traffic(cell, seed, dev)
        traffic.setup()
        traffic.warm()
        for side in ("program", "control"):
            planted = (cell["kind"].control(cell["format"])
                       if side == "control" else contextlib.nullcontext())
            with planted:
                traffic.reset()
                w = harness.Window(traffic)
                harness.plain_window(w, args.seconds)
                checks = traffic.check(w.failed)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, "attempted": len(w.calls),
                              "checks": {k: v for k, (v, _lim)
                                         in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
