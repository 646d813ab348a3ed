"""Run one cell of ``BENCHMARK.json`` on this machine's cards.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the cell's checks on standard error, then one JSON line as the
last line of standard output.  Exits with another code than 0, and prints
no result, without CUDA or with fewer cards than the cell asks for, or
when the JAX package (or JAX) was loaded into this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# modules whose top-level name, compared whole, may not be loaded: JAX
# and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# cache directories of the libraries the program may use, at fixed paths
# inside the checkout (the port's own kernel build is src/repro_torch/_build)
CACHE = ROOT / "_perfbench_cache"


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the
    modules loaded in this process), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch
    from perfbench.harness.cell import run_cell
    from perfbench.harness.spec import find_cell

    cell = find_cell(args.workload, root=ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda", t_start=T_START,
                   log=lambda m: print(m, file=sys.stderr))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {found}; the benchmark may not "
              f"run with JAX or the JAX package", file=sys.stderr)
        return 3
    for name, chk in out["checks"].items():
        print(f"check {name}: {chk['value']} (limit {chk['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
