"""Find the highest arrival rate an open-loop cell's system sustains: one
process, one set of weights, and for each rate a fresh engine warmed on
the head of the stream, then ``--seconds`` of the mix at that rate.

    python3 perfbench/sweep.py --workload <cell> --rates 2,3,4,5 \\
        --seconds 30 --seed 1

Prints one JSON line a rate: offered and completed requests a second,
requests in the system (sent, not finished) at the window's middle and
end, the 95th percentile of time to first token, and how late the
generator ran.  A rate is sustained where the backlog does not grow and
completions keep up with arrivals.  The benchmark's runs never run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    import torch
    from perfbench.harness import model as M
    from perfbench.harness.cell import pool
    from perfbench.harness.serve import ServedLoop, percentile
    from perfbench.harness.spec import find_cell
    from perfbench.harness.traffic import Stream
    from repro_torch.serving import PagedServingEngine
    from repro_torch.serving.engine import EngineRun
    from repro_torch.serving.scheduler import Request

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = find_cell(args.workload, root=ROOT)
    c = cell.config
    weights = M.make_weights(c, args.seed, "cuda")
    model, params = M.port_model(c, weights, "cuda")
    clock = time.perf_counter
    for rate in (float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic, rate_per_s=rate)
        stream = Stream(mix, args.seed, int(c["vocab_size"]),
                        int(c["serving"]["page_size"]))
        engine = PagedServingEngine(model, pool(c["serving"], stream),
                                    cache_dtype=torch.bfloat16)
        er = EngineRun(engine, params, clock=clock)
        loop = ServedLoop(er, stream, mix, clock, Request)
        loop.start()
        loop.run_until(n_done=int(mix["warmup_requests"]))
        w0 = clock()
        loop.run_until(t_end=w0 + args.seconds / 2)
        mid = sum(1 for s in loop.sent if not s.done)
        loop.run_until(t_end=w0 + args.seconds)
        w1 = clock()
        end = sum(1 for s in loop.sent if not s.done)
        due = [s for s in loop.sent if w0 <= s.t_due <= w1]
        done = [s for s in loop.sent if s.done and w0 <= s.req.t_done <= w1]
        ttft = [s.t_first - s.t_due for s in loop.sent
                if s.t_first is not None and w0 <= s.t_first <= w1]
        adm = [s for s in loop.sent if s.t_admit is not None
               and w0 <= s.t_admit <= w1]
        print(json.dumps({
            "workload": args.workload, "rate_per_s": rate,
            "offered_per_s": len(due) / (w1 - w0),
            "completed_per_s": len(done) / (w1 - w0),
            "in_system_mid": mid, "in_system_end": end,
            "ttft_p95_ms": (percentile(ttft, 95) or 0.0) * 1e3,
            "ttft_n": len(ttft),
            "prefix_hit_frac": (sum(s.shared for s in adm)
                                / max(1, sum(s.req.prompt_len for s in adm))),
            "generator_late_max_ms": max((s.t_send - s.t_due for s in due),
                                         default=0.0) * 1e3,
            "device": torch.cuda.get_device_name(0)}), flush=True)
        del loop, er, engine
        gc.collect()        # the engine and the loop's wrapper hold a cycle
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
