"""Per-shape launch-config autotuner for the port's CUDA kernels.

MetaML's claim is "automating the selection and configuration of low-level
optimization techniques"; here the low-level knobs are the launch
parameters the hand-written kernels take.  For a concrete (kernel, shape,
dtype, flags) problem this module

1. enumerates a *pruned* candidate space — for each kernel only the launch
   parameters its wrapper really takes (``block_m`` of
   block_sparse_matmul, ``block_q``/``block_kv`` of flash_attention,
   ``page_size`` of flash_decode_paged, ``block_q`` of
   flash_prefill_ragged; quant_matmul and flash_decode take none and have
   one candidate, their fixed launch), deduplicated on the launch the
   kernel would really run, and filtered by the dynamic shared memory that
   launch requests against :data:`SMEM_BUDGET` (a candidate that could not
   launch is never timed);
2. times every surviving candidate: the median µs per call over ``iters``
   calls, each followed by ``torch.cuda.synchronize()`` on the card (the
   plain versions on the CPU);
3. memoizes the winner in a persistent JSON cache keyed by
   ``kernel|problem`` — the JAX package's format and key — so later calls,
   including future processes, skip straight to the tuned config.

The kernel's default config is always part of the candidate space, so the
tuned config is never slower than the default *as measured*.

Cache file (``REPRO_TORCH_AUTOTUNE_CACHE`` or
~/.cache/repro_torch/autotune.json — never the JAX package's file)::

    {"version": 1,
     "entries": {
       "flash_attention|{\\"b\\":1,...}": {
         "config": {"block_q": 64, "block_kv": 128},
         "us": 1234.5, "n_trials": 13, "iters": 3,
         "smem_bytes": 99456, "smem_budget": 232448,
         "backend": "cuda:NVIDIA H100 80GB HBM3",
         "t": 1700000000.0}}}

``backend`` names the device kind, so an entry timed on the CPU never
stands in for a card's.  The TUNE O-task (tasks/tune.py) drives
:func:`tune` and republishes every trial as a ``SearchStep`` in the
MetaModel history; ``tuned_*`` wrappers give kernels-layer callers
tune-on-miss dispatch.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.search import SearchResult, exhaustive_search
from repro_torch.kernels import attention_tc as tc
from repro_torch.kernels import block_sparse_matmul as bsmm
from repro_torch.kernels import decode_tc as dtc
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_decode_paged as fdp
from repro_torch.kernels import flash_prefill_ragged as fpr
from repro_torch.kernels import gemm_tc
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.models.common import resolve_device

TILE_SIZES = (32, 64, 128, 256)
# The opt-in maximum of dynamic shared memory per block on Hopper (227 KB)
SMEM_BUDGET = 232_448
CACHE_ENV = "REPRO_TORCH_AUTOTUNE_CACHE"
CACHE_VERSION = 1
DEFAULT_PAGE_SIZE = 16


# --------------------------------------------------------------------- cache
def default_cache_path() -> str:
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


_MEM: dict[str, dict[str, Any]] = {}   # path -> {"entries": {...}} (loaded once)


def _load(path: str) -> dict[str, Any]:
    if path not in _MEM:
        data: dict[str, Any] = {"version": CACHE_VERSION, "entries": {}}
        try:
            with open(path) as f:
                raw = json.load(f)
            if raw.get("version") == CACHE_VERSION:
                data = raw
        except (OSError, ValueError):
            pass
        _MEM[path] = data
    return _MEM[path]


def _store(path: str, key: str, entry: dict[str, Any]) -> None:
    # Merge against a fresh read of the file, not the process snapshot:
    # concurrent writers (pytest-xdist, a flow next to a bench) would
    # otherwise have their entries clobbered by our stale view.  The temp
    # name is per-writer so two simultaneous stores cannot interleave
    # inside one file; last os.replace wins.
    _MEM.pop(path, None)
    _TILES.clear()
    data = _load(path)
    data["entries"][key] = entry
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    os.replace(tmp, path)


def clear_memory_cache() -> None:
    """Drop the in-process view of every cache file and the benchmark
    inputs kept between candidates (tests; frees their device memory)."""
    _MEM.clear()
    _RESOLVED.clear()
    _TILES.clear()
    _inputs.cache_clear()


def cache_key(kernel: str, problem: dict[str, Any]) -> str:
    return f"{kernel}|{json.dumps(problem, sort_keys=True)}"


def dtype_name(dtype) -> str:
    """The JAX package's dtype names (``"bfloat16"``, ``"float32"``) for a
    torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        name = dtype.removeprefix("torch.")
        if isinstance(getattr(torch, name, None), torch.dtype):
            return name
    return np.dtype(dtype).name


def backend_name(device=None) -> str:
    """The device kind a timing belongs to: ``"cpu"`` or
    ``"cuda:<card name>"``.  ``None`` means the card (raises without
    one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


# ------------------------------------------------------------------- results
@dataclasses.dataclass(frozen=True)
class Trial:
    config: dict[str, int]
    us: float
    smem_bytes: int
    smem_budget: int


@dataclasses.dataclass
class TuneResult:
    kernel: str
    key: str
    config: dict[str, int]
    us: float
    cached: bool
    trials: list[Trial] = dataclasses.field(default_factory=list)
    search: SearchResult | None = None   # None on a cache hit

    @property
    def default_us(self) -> float | None:
        default = KERNELS[self.kernel].default_config
        for t in self.trials:
            if t.config == default:
                return t.us
        return None


# ------------------------------------------------------- kernel descriptors
def _divides(tile: int, dim: int) -> bool:
    return dim % min(tile, dim) == 0


def _axis(default: int, extra: tuple[int, ...] = ()) -> tuple[int, ...]:
    """Tile sizes for one dim, default first: when small problem dims clamp
    several nominal tiles to the same effective tile, the dedup in the
    candidate generators keeps the first-seen config — default-first makes
    that representative the literal default config, preserving the
    'default is always measured' invariant (and TuneResult.default_us)."""
    sizes = set(TILE_SIZES) | set(extra) | {default}
    return tuple(sorted(sizes, key=lambda t: (t != default, t)))


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One tunable kernel: candidate model + benchmark-input factory."""

    name: str
    default_config: dict[str, int]
    candidates: Callable[[dict[str, Any]], list[tuple[dict[str, int], int]]]
    make_runner: Callable[[dict[str, Any], dict[str, int], str],
                          Callable[[], Any]]


@functools.lru_cache(maxsize=2)
def _inputs(kind: str, problem_json: str, device: str, extra: int = 0):
    """Benchmark inputs of one problem on ``device``, drawn from a seeded
    generator there; built once per search, not per candidate (two kept,
    so the card holds at most two problems' inputs)."""
    p = json.loads(problem_json)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    dt = getattr(torch, p["dtype"])

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dt)

    if kind == "mm":
        return randn(p["m"], p["k"]), randn(p["k"], p["n"])
    if kind == "fa":
        kv = (p["b"], p["skv"], p["kv_heads"], p["d"])
        return randn(p["b"], p["sq"], p["h"], p["d"]), randn(*kv), \
            randn(*kv)
    if kind == "fd":
        b, kvh, d, n = p["b"], p["kv_heads"], p["d"], p["cache_len"]
        # a full cache is the steady-state (and worst-case) decode problem
        mask = torch.ones((n,), dtype=torch.bool, device=device)
        return randn(b, 1, p["h"], d), randn(b, n, kvh, d), \
            randn(b, n, kvh, d), mask
    # paged kinds: ``extra`` is the pool's page size
    ps = extra
    slots, kvh, d, max_len = p["slots"], p["kv_heads"], p["d"], p["max_len"]
    blocks = -(-max_len // ps)
    n_pages = slots * blocks + 1           # + the reserved scratch page
    kp = randn(n_pages, ps, kvh, d)
    vp = randn(n_pages, ps, kvh, d)
    bt = 1 + torch.arange(slots * blocks, dtype=torch.int32,
                          device=device).reshape(slots, blocks)
    if kind == "fpd":
        # steady-state (worst-case) decode: every request near capacity
        mask = (torch.arange(blocks * ps, device=device)[None, :]
                < max_len).expand(slots, blocks * ps).contiguous()
        return randn(slots, 1, p["h"], d), kp, vp, bt, mask
    # fpr: every suffix sits at the end of a near-full prefix, so each
    # query attends the whole history
    s = p["s"]
    off = torch.full((slots,), max(0, max_len - s), dtype=torch.int32,
                     device=device)
    lens = torch.full((slots,), s, dtype=torch.int32, device=device)
    return randn(slots, s, p["h"], d), kp, vp, bt, off, lens


def _pj(problem: dict[str, Any]) -> str:
    return json.dumps(problem, sort_keys=True)


# flash attention ------------------------------------------------------------
def _tc_axis(default: int) -> tuple[int, ...]:
    """The tensor-core variant's tiles, the kernel default first (a
    default it does not take maps onto one of them and stands for it)."""
    return (default,) + tuple(t for t in tc.TILES if t != default)


def _fa_candidates(problem: dict[str, Any]
                   ) -> list[tuple[dict[str, int], int]]:
    d, dtype = problem["d"], problem["dtype"]
    var = tc.variant(dtype, dtype, d)
    if var == "tc":
        q_axis, kv_axis = _tc_axis(fa.BQ), _tc_axis(fa.BKV)
    else:
        q_axis, kv_axis = _axis(fa.BQ), _axis(fa.BKV)
    out, seen = [], set()
    for bq in q_axis:
        for bkv in kv_axis:
            eff = fa.effective_tiles(bq, bkv, problem["sq"], problem["skv"],
                                     var)
            if eff in seen:     # clamped duplicates run the same launch
                continue
            seen.add(eff)
            smem = tc.smem_bytes(*eff, d) if var == "tc" \
                else fa.smem_bytes(*eff, d, dtype)
            out.append(({"block_q": bq, "block_kv": bkv}, smem))
    return out


def _fa_runner(problem: dict[str, Any], cfg: dict[str, int],
               device: str) -> Callable[[], Any]:
    q, k, v = _inputs("fa", _pj(problem), device)
    return lambda: fa.flash_attention(
        q, k, v, causal=problem["causal"], window=problem["window"],
        block_q=cfg["block_q"], block_kv=cfg["block_kv"])


def flash_attention_problem(q_shape, kv_shape, dtype, *,
                            causal: bool = True,
                            window: int = 0) -> dict[str, Any]:
    b, sq, h, d = (int(x) for x in q_shape)
    _, skv, kvh, _ = (int(x) for x in kv_shape)
    return {"b": b, "sq": sq, "h": h, "d": d, "skv": skv, "kv_heads": kvh,
            "dtype": dtype_name(dtype), "causal": bool(causal),
            "window": int(window)}


# flash decode ---------------------------------------------------------------
def _fd_candidates(problem: dict[str, Any]
                   ) -> list[tuple[dict[str, int], int]]:
    # the kernel picks its own tiling: one launch to time
    g, d = problem["h"] // problem["kv_heads"], problem["d"]
    if dtc.variant(problem["dtype"], problem["dtype"], d) == "tc":
        return [({}, dtc.smem_bytes(d, dtc.CHUNK))]
    return [({}, fd.smem_bytes(g, d))]


def _fd_runner(problem: dict[str, Any], cfg: dict[str, int],
               device: str) -> Callable[[], Any]:
    q, k, v, mask = _inputs("fd", _pj(problem), device)
    return lambda: fd.flash_decode(q, k, v, mask)


def flash_decode_problem(q_shape, kv_shape, dtype) -> dict[str, Any]:
    b, _, h, d = (int(x) for x in q_shape)
    _, skv, kvh, _ = (int(x) for x in kv_shape)
    return {"b": b, "h": h, "d": d, "kv_heads": kvh, "cache_len": skv,
            "dtype": dtype_name(dtype)}


# paged flash decode ---------------------------------------------------------
def _fpd_candidates(problem: dict[str, Any]
                    ) -> list[tuple[dict[str, int], int]]:
    # page_size is the pool's allocation granule and the kernel's page
    # walk.  Ascending enumeration + effective-coverage dedup (the smallest
    # covering page keeps pool padding minimal); the default page size is
    # force-included even when it collapses, as in the JAX package.
    out, seen = [], set()
    for ps in sorted(set(TILE_SIZES) | {8, 16, DEFAULT_PAGE_SIZE}):
        eff = min(ps, problem["max_len"])
        if eff in seen and ps != DEFAULT_PAGE_SIZE:
            continue
        seen.add(eff)
        out.append(({"page_size": ps}, _fpd_smem(problem, ps)))
    return out


def _fpd_smem(problem: dict[str, Any], page_size: int) -> int:
    """Shared memory of a flash_decode_paged launch at ``page_size``, for
    the variant the problem's dtype and D take."""
    g, d = problem["h"] // problem["kv_heads"], problem["d"]
    if dtc.variant(problem["dtype"], problem["dtype"], d) == "tc":
        return fdp.smem_bytes_tc(d, page_size)
    return fdp.smem_bytes(g, d, page_size)


def _fpd_runner(problem: dict[str, Any], cfg: dict[str, int],
                device: str) -> Callable[[], Any]:
    q, kp, vp, bt, mask = _inputs("fpd", _pj(problem), device,
                                  cfg["page_size"])
    return lambda: fdp.flash_decode_paged(q, kp, vp, bt, mask)


def flash_decode_paged_problem(slots: int, h: int, kv_heads: int, d: int,
                               max_len: int, dtype) -> dict[str, Any]:
    return {"slots": int(slots), "h": int(h), "kv_heads": int(kv_heads),
            "d": int(d), "max_len": int(max_len),
            "dtype": dtype_name(dtype)}


# paged decode segment -------------------------------------------------------
# Not a kernel tile but the serving engine's decode-segment cadence: the
# engine runs segment_len decode steps as one device loop and wakes the
# host only at segment boundaries.  Long segments amortize the host sync
# per token; short ones react faster.  Every candidate generates the SAME
# token budget split into segments of its length, with one host readback
# per segment — the engine's boundary pattern.  The engine reads the
# winner back through serving/paged_cache.py::preferred_segment_len.
SEGMENT_TOKENS = 32          # fixed token budget every candidate pays


def _pseg_candidates(problem: dict[str, Any]
                     ) -> list[tuple[dict[str, int], int]]:
    smem = _fpd_smem(problem, problem["page_size"])
    return [({"segment_len": sl}, smem) for sl in (2, 4, 8, 16,
                                                   SEGMENT_TOKENS)]


def _pseg_runner(problem: dict[str, Any], cfg: dict[str, int],
                 device: str) -> Callable[[], Any]:
    """``SEGMENT_TOKENS // segment_len`` segments, each ``segment_len``
    launches of flash_decode_paged with every request's mask advanced one
    slot per step (starting half full), each segment ending in one host
    readback of its outputs — the JAX package's jitted scan per segment
    and ``block_until_ready``, and the engine's control pull at a
    boundary."""
    seg_len = min(cfg["segment_len"], SEGMENT_TOKENS)
    reps = SEGMENT_TOKENS // seg_len
    q, kp, vp, bt, _ = _inputs("fpd", _pj(problem), device,
                               problem["page_size"])
    slots, max_len = problem["slots"], problem["max_len"]
    pos = torch.arange(bt.shape[1] * problem["page_size"],
                       device=device)[None, :]
    sl0 = torch.full((slots,), max(1, max_len // 2), dtype=torch.int32,
                     device=device)

    def run():
        sl, outs = sl0, None
        for _ in range(reps):
            step_outs = []
            for _ in range(seg_len):
                mask = pos < torch.clamp(sl + 1, max=max_len)[:, None]
                out = fdp.flash_decode_paged(q, kp, vp, bt, mask)
                step_outs.append(out[:, 0, 0, 0])
                sl = torch.clamp(sl + 1, max=max_len - 1)
            # the engine pulls control state back at every boundary;
            # this readback reproduces that sync once per segment
            outs = torch.stack(step_outs).cpu()
        return outs

    return run


def paged_segment_problem(slots: int, h: int, kv_heads: int, d: int,
                          max_len: int, page_size: int,
                          dtype) -> dict[str, Any]:
    return {"slots": int(slots), "h": int(h), "kv_heads": int(kv_heads),
            "d": int(d), "max_len": int(max_len),
            "page_size": int(page_size), "dtype": dtype_name(dtype)}


# ragged paged prefill -------------------------------------------------------
def _fpr_candidates(problem: dict[str, Any]
                    ) -> list[tuple[dict[str, int], int]]:
    # block_q tiles the suffix-query axis; the kv axis is walked page by
    # page (the pool's page size is part of the problem).  The wrapper
    # clamps block_q to the suffix length, so duplicates collapse.  The
    # tensor-core variant takes block_q 64 or 128 (the default 32 runs 64).
    g = problem["h"] // problem["kv_heads"]
    d, dtype = problem["d"], problem["dtype"]
    on_tc = tc.variant(dtype, dtype, d) == "tc"
    out, seen = [], set()
    for bq in _tc_axis(fpr.BQ) if on_tc else _axis(fpr.BQ, (8, 16)):
        eff = fpr.effective_block_q(bq, problem["s"], "tc", g, d,
                                    problem["page_size"]) if on_tc \
            else min(bq, problem["s"])
        if eff in seen:
            continue
        seen.add(eff)
        out.append(({"block_q": bq}, fpr.smem_bytes_tc(eff, d) if on_tc
                    else fpr.smem_bytes(eff, g, d, problem["page_size"])))
    return out


def _fpr_runner(problem: dict[str, Any], cfg: dict[str, int],
                device: str) -> Callable[[], Any]:
    q, kp, vp, bt, off, lens = _inputs("fpr", _pj(problem), device,
                                       problem["page_size"])
    return lambda: fpr.flash_prefill_ragged(q, kp, vp, bt, off, lens,
                                            block_q=cfg["block_q"])


def flash_prefill_ragged_problem(slots: int, s: int, h: int, kv_heads: int,
                                 d: int, max_len: int, page_size: int,
                                 dtype) -> dict[str, Any]:
    """``s`` is the padded suffix bucket, ``max_len`` the logical slots
    per request (block-table width x page size)."""
    return {"slots": int(slots), "s": int(s), "h": int(h),
            "kv_heads": int(kv_heads), "d": int(d),
            "max_len": int(max_len), "page_size": int(page_size),
            "dtype": dtype_name(dtype)}


# quant matmul ---------------------------------------------------------------
def _qmm_candidates(problem: dict[str, Any]
                    ) -> list[tuple[dict[str, int], int]]:
    # the launch takes no tile config (the tc plan is a function of the
    # shape): one launch to time, at the shared memory of the variant the
    # problem takes
    return [({}, qmm.smem_bytes(problem["m"], problem["n"], problem["k"]))]


def _qmm_runner(problem: dict[str, Any], cfg: dict[str, int],
                device: str) -> Callable[[], Any]:
    x, w = _inputs("mm", _pj(problem), device)
    return lambda: qmm.quant_matmul(x, w)


def quant_matmul_problem(x_shape, w_shape, dtype, *,
                         out_dtype="float32") -> dict[str, Any]:
    m, k = (int(v) for v in x_shape)
    _, n = (int(v) for v in w_shape)
    return {"m": m, "k": k, "n": n, "dtype": dtype_name(dtype),
            "out_dtype": dtype_name(out_dtype)}


# block-sparse matmul --------------------------------------------------------
def _bsmm_candidates(problem: dict[str, Any]
                     ) -> list[tuple[dict[str, int], int]]:
    m = problem["m"]
    on_tc = gemm_tc.bsmm_variant(problem["dtype"]) == "tc"
    # the tc kernel's tiles (a request maps to the nearest), or the fp32
    # kernel's axis; default first either way
    axis = (128,) + tuple(t for t in gemm_tc.BSMM_TILES if t != 128) \
        if on_tc else _axis(128)
    out, seen = [], set()
    for bm in axis:
        if not _divides(bm, m):
            continue
        eff = min(bm, m)
        if on_tc:
            eff = gemm_tc.bsmm_tile(eff)
        if eff in seen:
            continue
        seen.add(eff)
        out.append(({"block_m": bm}, bsmm.smem_bytes(min(bm, m),
                                                     problem["dtype"])))
    return out


def _bsmm_runner(problem: dict[str, Any], cfg: dict[str, int],
                 device: str) -> Callable[[], Any]:
    block = problem["block"]
    x, w = _inputs("mm", _pj(problem), device)
    nb = problem["n"] // block
    live = min(problem["max_live"], problem["k"] // block)
    kidx = torch.arange(live, dtype=torch.int32, device=device).repeat(nb, 1)
    return lambda: bsmm.block_sparse_matmul(x, w, kidx, block=block,
                                            block_m=cfg["block_m"])


def block_sparse_matmul_problem(x_shape, w_shape, dtype, *,
                                max_live: int,
                                block: int = 128) -> dict[str, Any]:
    m, k = (int(v) for v in x_shape)
    _, n = (int(v) for v in w_shape)
    return {"m": m, "k": k, "n": n, "block": int(block),
            "max_live": int(max_live), "dtype": dtype_name(dtype)}


KERNELS: dict[str, KernelEntry] = {
    "flash_attention": KernelEntry(
        "flash_attention", {"block_q": fa.BQ, "block_kv": fa.BKV},
        _fa_candidates, _fa_runner),
    "flash_decode": KernelEntry(
        "flash_decode", {}, _fd_candidates, _fd_runner),
    "flash_decode_paged": KernelEntry(
        "flash_decode_paged", {"page_size": DEFAULT_PAGE_SIZE},
        _fpd_candidates, _fpd_runner),
    "paged_segment": KernelEntry(
        "paged_segment", {"segment_len": 8},
        _pseg_candidates, _pseg_runner),
    "flash_prefill_ragged": KernelEntry(
        "flash_prefill_ragged", {"block_q": fpr.BQ},
        _fpr_candidates, _fpr_runner),
    "quant_matmul": KernelEntry(
        "quant_matmul", {}, _qmm_candidates, _qmm_runner),
    "block_sparse_matmul": KernelEntry(
        "block_sparse_matmul", {"block_m": 128},
        _bsmm_candidates, _bsmm_runner),
}


# ------------------------------------------------------------------- tuning
def _default_timer(fn, *, warmup: int, iters: int, device: str) -> float:
    """Median µs per call over ``iters`` calls, each followed by a
    synchronize on the card (the contract of the JAX package's
    ``_fallback_timeit``)."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def _config_distance(cfg: dict[str, int], default: dict[str, int]) -> float:
    return sum(abs(math.log2(cfg[k]) - math.log2(default[k]))
               for k in default)


def enumerate_candidates(kernel: str, problem: dict[str, Any], *,
                         smem_budget: int = SMEM_BUDGET,
                         max_trials: int | None = None
                         ) -> list[tuple[dict[str, int], int]]:
    """Pruned candidate list for ``kernel`` on ``problem``:
    ``[(config, smem_bytes)]``.

    Configs whose launch would request more dynamic shared memory than
    ``smem_budget`` are dropped; the remainder is ordered default-first
    (distance in log2-tile space) and optionally capped at ``max_trials``
    — the default config survives any cap, which is what guarantees
    tuned-never-slower-than-default.
    """
    entry = KERNELS[kernel]
    cands = [(c, s) for c, s in entry.candidates(problem)
             if s <= smem_budget]
    cands.sort(key=lambda cs: (_config_distance(cs[0], entry.default_config),
                               sorted(cs[0].items())))
    if max_trials is not None:
        cands = cands[:max(1, max_trials)]
    return cands


def tune(kernel: str, problem: dict[str, Any], *,
         cache_path: str | None = None,
         force: bool = False,
         device=None,
         iters: int = 3, warmup: int = 1,
         max_trials: int | None = 16,
         smem_budget: int = SMEM_BUDGET,
         timer: Callable[..., float] | None = None) -> TuneResult:
    """Find (or recall) the best launch config for ``kernel`` on
    ``problem``, timed on ``device`` (the card unless ``"cpu"``).

    On a cache hit the measurement loop is skipped entirely; on a miss every
    surviving candidate is timed and the winner is persisted.
    """
    if kernel not in KERNELS:
        raise KeyError(f"unknown tunable kernel {kernel!r}; "
                       f"have {sorted(KERNELS)}")
    dev = str(resolve_device(device))
    backend = backend_name(dev)
    path = cache_path or default_cache_path()
    key = cache_key(kernel, problem)
    if not force:
        entry = _load(path)["entries"].get(key)
        # A cached entry only counts if it is evidence for THIS request:
        # same backend (CPU timings say nothing about the card), at least
        # as deep a search, and at least as many timing iters as now
        # requested (a shallow/noisy sweep must not permanently shadow a
        # fuller TUNE search).
        if entry is not None and entry.get("backend") == backend \
                and entry.get("iters", 0) >= iters \
                and entry.get("smem_budget", float("inf")) <= smem_budget:
            requested = len(enumerate_candidates(
                kernel, problem, smem_budget=smem_budget,
                max_trials=max_trials))
            if entry.get("n_trials", 0) >= requested:
                return TuneResult(kernel, key, dict(entry["config"]),
                                  float(entry["us"]), cached=True)

    timer = timer or functools.partial(_default_timer, device=dev)
    spec = KERNELS[kernel]
    cands = enumerate_candidates(kernel, problem, smem_budget=smem_budget,
                                 max_trials=max_trials)
    if not cands:
        raise ValueError(f"{kernel}: no feasible launch candidate for "
                         f"{problem} under smem_budget={smem_budget}")
    smem_of = {json.dumps(c, sort_keys=True): s for c, s in cands}
    trials: list[Trial] = []

    def evaluate(cfg: dict[str, int]):
        smem = smem_of[json.dumps(cfg, sort_keys=True)]
        runner = spec.make_runner(problem, cfg, dev)
        us = float(timer(runner, warmup=warmup, iters=iters))
        trials.append(Trial(dict(cfg), us, smem, smem_budget))
        # maximize -latency; every pre-pruned candidate is feasible
        return True, -us, {"us": us, "smem_bytes": smem,
                           "smem_budget": smem_budget}

    search = exhaustive_search([c for c, _ in cands], evaluate)
    best_cfg, best_us = dict(search.best_x), -search.best_objective
    _store(path, key, {"config": best_cfg, "us": best_us,
                       "n_trials": len(trials), "iters": iters,
                       "smem_bytes": smem_of[json.dumps(best_cfg,
                                                        sort_keys=True)],
                       "smem_budget": smem_budget, "backend": backend,
                       "t": time.time()})
    return TuneResult(kernel, key, best_cfg, best_us,
                      cached=False, trials=trials, search=search)


def cached_config(kernel: str, problem: dict[str, Any], *,
                  cache_path: str | None = None,
                  relax: tuple[str, ...] = (),
                  device=None) -> dict[str, int]:
    """Persisted tuned config for ``problem`` on ``device``'s backend, or
    the kernel default.

    Never tunes and never times — a pure (memoized) cache read, falling
    back to the default config on a miss or a backend mismatch.

    ``relax``: problem fields allowed to differ on fallback matching (the
    nearest tuned entry, log-distance over the relaxed dims, stands in),
    so tuning wins reach shapes TUNE never saw exactly.  Configs stay
    valid across the relaxation because kernels clamp tiles to the
    problem dims.
    """
    cfg, _ = cached_config_info(kernel, problem, cache_path=cache_path,
                                relax=relax, device=device)
    return cfg


def cached_config_info(kernel: str, problem: dict[str, Any], *,
                       cache_path: str | None = None,
                       relax: tuple[str, ...] = (),
                       device=None) -> tuple[dict[str, int], str]:
    """:func:`cached_config` plus where the answer came from: ``"tuned"``
    (exact backend-matched hit), ``"relaxed"`` (nearest tuned entry over
    the relaxed fields), or ``"default"`` (kernel default on a miss)."""
    backend = backend_name(device)
    path = cache_path or default_cache_path()
    entries = _load(path)["entries"]
    entry = entries.get(cache_key(kernel, problem))
    if entry is not None and entry.get("backend") == backend:
        return dict(entry["config"]), "tuned"
    if relax:
        strict = {k: v for k, v in problem.items() if k not in relax}
        prefix = f"{kernel}|"
        best: tuple[float, dict[str, Any]] | None = None
        for key, e in entries.items():
            if not key.startswith(prefix) or e.get("backend") != backend:
                continue
            try:
                p = json.loads(key[len(prefix):])
            except ValueError:      # pragma: no cover - corrupt entry
                continue
            if {k: v for k, v in p.items() if k not in relax} != strict:
                continue
            dist = sum(abs(math.log(max(float(p.get(f, 1)), 1.0))
                           - math.log(max(float(problem.get(f, 1)), 1.0)))
                       for f in relax)
            if best is None or dist < best[0]:
                best = (dist, e)
        if best is not None:
            return dict(best[1]["config"]), "relaxed"
    return dict(KERNELS[kernel].default_config), "default"


# The one registry of relax keys per kernel: which problem fields a
# deployment-time readback may differ from the TUNE run's proxy problem in
# (batch/slot count and cache length scale with deployment, tile choices
# don't).
TILE_RELAX: dict[str, tuple[str, ...]] = {
    "flash_decode": ("b", "cache_len"),
    "flash_decode_paged": ("slots", "max_len"),
    "paged_segment": ("slots", "max_len"),
    "flash_prefill_ragged": ("slots", "s", "max_len"),
}


def tile_readback(kernel: str, problem: dict[str, Any], *,
                  cache_path: str | None = None,
                  device=None) -> tuple[dict[str, int], str]:
    """Consolidated autotune-cache readback: ``cached_config`` under the
    kernel's registered :data:`TILE_RELAX` fields, returning
    ``(config, provenance)``.  Pure read."""
    return cached_config_info(kernel, problem, cache_path=cache_path,
                              relax=TILE_RELAX.get(kernel, ()),
                              device=device)


_TILES: dict[tuple, tuple[dict[str, int], str]] = {}


def memo_tile_readback(kernel: str, problem: dict[str, Any], *,
                       device=None) -> tuple[dict[str, int], str]:
    """:func:`tile_readback` against the default cache, read once per
    (kernel, problem, device, cache file) in this process — for readbacks
    inside a model's forward, which the JAX package pays once per trace.
    Every cache store and :func:`clear_memory_cache` drop the memo."""
    key = (kernel, tuple(sorted(problem.items())), str(device),
           default_cache_path())
    hit = _TILES.get(key)
    if hit is None:
        hit = _TILES[key] = tile_readback(kernel, problem, device=device)
    return hit


_RESOLVED: dict[tuple, dict[str, int]] = {}   # per-process get_config memo


def get_config(kernel: str, problem: dict[str, Any],
               **tune_kwargs: Any) -> dict[str, int]:
    """Tuned config for ``problem``; tunes on cache miss.

    After the first call per process the lookup is a pure in-memory dict
    hit — no candidate enumeration, no file IO, no measurement.
    """
    memoizable = not tune_kwargs.get("force") \
        and "timer" not in tune_kwargs
    memo_key = (kernel, cache_key(kernel, problem),
                backend_name(tune_kwargs.get("device")),
                tune_kwargs.get("cache_path"),
                tune_kwargs.get("max_trials", 16),
                tune_kwargs.get("smem_budget", SMEM_BUDGET),
                tune_kwargs.get("iters", 3))
    if memoizable and memo_key in _RESOLVED:
        return _RESOLVED[memo_key]
    cfg = tune(kernel, problem, **tune_kwargs).config
    if memoizable:
        _RESOLVED[memo_key] = cfg
    return cfg


# ------------------------------------------------------- tuned dispatchers
# Each tunes (or recalls) on the device of its first tensor and launches
# the kernel there with the winning config.
def tuned_flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                          cache_path: str | None = None,
                          **tune_kwargs: Any):
    cfg = get_config(
        "flash_attention",
        flash_attention_problem(q.shape, k.shape, q.dtype,
                                causal=causal, window=window),
        cache_path=cache_path, device=q.device, **tune_kwargs)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              block_q=cfg["block_q"],
                              block_kv=cfg["block_kv"])


def tuned_flash_decode(q, k, v, mask, *, cache_path: str | None = None,
                       **tune_kwargs: Any):
    get_config("flash_decode", flash_decode_problem(q.shape, k.shape,
                                                    q.dtype),
               cache_path=cache_path, device=q.device, **tune_kwargs)
    return fd.flash_decode(q, k, v, mask)   # its one launch config


def tuned_quant_matmul(x, w, *, cache_path: str | None = None,
                       **tune_kwargs: Any):
    get_config("quant_matmul", quant_matmul_problem(x.shape, w.shape,
                                                    x.dtype),
               cache_path=cache_path, device=x.device, **tune_kwargs)
    return qmm.quant_matmul(x, w)           # its one launch config


def tuned_block_sparse_matmul(x, w, kindex, *, block: int = 128,
                              cache_path: str | None = None,
                              **tune_kwargs: Any):
    cfg = get_config(
        "block_sparse_matmul",
        block_sparse_matmul_problem(x.shape, w.shape, x.dtype,
                                    max_live=int(kindex.shape[1]),
                                    block=block),
        cache_path=cache_path, device=x.device, **tune_kwargs)
    return bsmm.block_sparse_matmul(x, w, kindex, block=block,
                                    block_m=cfg["block_m"])
