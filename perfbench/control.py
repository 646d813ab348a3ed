"""Read the limit's two sides for one cell on the chip: the sound
program's numbers on many seeds, and the control's (the same prompts
and served tokens read by the port under its own FP8 precision level,
the precision below the configuration's bf16) on the first few.

    python3 perfbench/control.py --workload <cell> --seeds 101,102,... \\
        --seconds 8 --control-seeds 3

One process serves every seed (set-up, a short window at the cell's own
load, the comparison), so the kernels build once.  Prints one JSON line
per seed.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from perfbench.harness.cell import run_cell
    from perfbench.harness.spec import find_cell
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload, root=ROOT)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, device="cuda",
                       control=i < args.control_seeds,
                       log=lambda m: print(m, file=sys.stderr))
        torch.cuda.reset_peak_memory_stats()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "readings": out["readings"],
                          "metrics": out["metrics"],
                          "run_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
