"""Roofline terms of a dry-run cell: the port of the JAX package's
``launch/roofline.py`` for an NVIDIA H100.

    compute term    = FLOPs per chip            / peak FLOP/s
    memory term     = bytes accessed per chip   / HBM bytes/s
    collective term = collective bytes per chip / link bytes/s

There is no HLO to parse.  A cell's program (``launch/dryrun.py``) runs
once on ``meta`` tensors — one rank's shards of a placeholder world —
under :class:`DryRunCounter`, which sees each rank-local op:

- FLOPs: ``torch.utils.flop_counter``'s formulas per op (the port's
  ``repro_torch::matmul`` and ``repro_torch::int8_matmul`` as 2·M·K·N;
  the sLSTM time loop ``repro_torch::slstm_scan`` as its recurrent
  products, 2·B·S·4·H·dh², and its backward as three times that: the
  recompute and the two products of each step's gradient);
- bytes accessed: each op's input tensors read once and output tensors
  written once, view and metadata ops free — the traffic of the port's
  unfused op-by-op execution, an upper bound on a fused program's (the
  sLSTM loop, one op, counts its inputs and outputs only);
- collective bytes: the operand bytes of each functional collective
  (all-gather: its input; reduce-scatter: its input, the reference's
  result × group; all-reduce and all-to-all: the operand); the counts
  come from ``torch.distributed.tensor.debug.CommDebugMode``
  (``launch/dryrun.py::Lowered.compile``);
- memory: the arguments' local bytes (parameters, moments, inputs,
  cache) and the peak of the live bytes the program allocates beyond
  them (each new storage counted until it is freed) — ``temp_bytes``.

Hardware constants: ``NVIDIA H100 80GB HBM3, 700 W`` (the SXM part).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

HW = {
    # NVIDIA H100 80GB HBM3, 700 W: dense bf16 tensor-core peak (NVIDIA
    # H100 data sheet, SXM, without sparsity)
    "peak_flops": 989e12,
    # NVIDIA H100 80GB HBM3, 700 W: HBM3 bandwidth (data sheet, SXM)
    "hbm_bw": 3.35e12,
    # NVIDIA H100 80GB HBM3, 700 W: NVLink 4, 900 GB/s in both directions
    # (data sheet), 450e9 B/s a direction
    "link_bw": 450e9,
    # NVIDIA H100 80GB HBM3, 700 W: HBM capacity (data sheet)
    "hbm_bytes": 80e9,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")
# functional collective op → the reference's kind
FUNCOL_KIND = {"all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "collective-permute"}
# ops that move no data: views and metadata
_FREE = {"view", "_unsafe_view", "reshape", "expand", "t", "transpose",
         "permute", "select", "slice", "unsqueeze", "squeeze", "alias",
         "detach", "as_strided", "split", "split_with_sizes", "unbind",
         "chunk", "narrow", "view_as", "diagonal", "lift_fresh",
         "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "wait_tensor", "unfold"}


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _mm_flops(func, args) -> float | None:
    """The port's product ops: 2·M·K·N."""
    name = str(func.overloadpacket)
    if name.endswith("repro_torch.matmul"):
        x, w = args[0], args[1]
        return 2.0 * x.numel() * w.shape[1]
    if name.endswith("repro_torch.int8_matmul"):
        xq, wq = args[0], args[2]
        return 2.0 * xq.numel() * wq.shape[0]
    if name.endswith("repro_torch.slstm_scan"):
        wx, r = args[0], args[1]          # (B, S, 4, H, dh), (4, H, dh, dh)
        return 2.0 * wx.numel() * r.shape[-1]
    if name.endswith("repro_torch.slstm_scan_backward"):
        wx, r = args[0], args[1]
        return 3 * 2.0 * wx.numel() * r.shape[-1]
    return None


@dataclasses.dataclass
class CollectiveStats:
    operand_bytes: dict[str, float]
    counts: dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.operand_bytes.values())


class DryRunCounter(TorchDispatchMode):
    """Counts one rank's work while a program runs on DTensors over meta
    tensors: the ops whose arguments are local (plain) tensors, i.e.
    what DTensor executes on this rank — an op on DTensors is left to
    DTensor (``NotImplemented``), which runs its local ops through here,
    and DTensor's own shape propagation (fake tensors) is skipped.
    ``arg_storages``: the storages the program receives (not counted as
    temporaries)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = {k: 0.0 for k in _COLLECTIVES}
        self.coll_counts = {k: 0 for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self._held: dict[int, int] = {}
        self._args: set[int] = set()

    def hold_args(self, tensors) -> int:
        """Mark ``tensors``' storages as arguments; their bytes."""
        total = 0
        for t in tensors:
            st = t.untyped_storage()
            if id(st) not in self._args:
                self._args.add(id(st))
                total += st.nbytes()
        return total

    def _track(self, out) -> None:
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self._held or key in self._args:
                continue
            n = st.nbytes()
            self._held[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        flat = tree_flatten((args, kwargs))[0]
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(isinstance(a, FakeTensor)
               for a in flat + tree_flatten(out)[0]):
            return out        # DTensor's shape propagation, not a rank's op
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in FUNCOL_KIND:
            kind = FUNCOL_KIND[name]
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += sum(
                _bytes(t) for t in tree_flatten(args)[0]
                if isinstance(t, torch.Tensor))
        else:
            f = _mm_flops(func, args)
            if f is None:
                from torch.utils.flop_counter import flop_registry
                formula = flop_registry.get(func.overloadpacket)
                f = formula(*args, **kwargs, out_val=out) if formula else 0
            self.flops += float(f)
            if name not in _FREE:
                self.bytes += sum(_bytes(t) for t in flat + tree_flatten(
                    out)[0] if isinstance(t, torch.Tensor))
        self._track(out)
        return out

    def collectives(self) -> CollectiveStats:
        return CollectiveStats(dict(self.coll_bytes), dict(self.coll_counts))


def roofline(compiled, mesh,
             model_flops: float | None = None) -> dict[str, Any]:
    """Roofline terms from a ``launch.dryrun.Compiled`` (its counters are
    per chip already: one rank's program).  The reference's keys: its
    ``raw_*`` terms are the traced ones and ``scan_corrected`` is False,
    since the port traces every layer (``launch/dryrun.py``)."""
    chips = int(mesh.size())
    ca = compiled.cost_analysis()
    flops = float(ca["flops"])
    byts = float(ca["bytes accessed"])
    coll = compiled.collectives
    raw = {"raw_flops": flops, "raw_bytes": byts,
           "raw_collective_bytes": coll.total_bytes}
    compute_t = flops / HW["peak_flops"]
    memory_t = byts / HW["hbm_bw"]
    collective_t = coll.total_bytes / HW["link_bw"]
    ma = compiled.memory_analysis()
    mem = {"argument_bytes": ma.argument_size_in_bytes,
           "output_bytes": ma.output_size_in_bytes,
           "temp_bytes": ma.temp_size_in_bytes,
           "peak_bytes": (ma.argument_size_in_bytes
                          + ma.temp_size_in_bytes)}
    terms = {"compute_s": compute_t, "memory_s": memory_t,
             "collective_s": collective_t}
    dominant = max(terms, key=terms.get)
    out = {
        **terms,
        "dominant": dominant,
        "bound_s": max(terms.values()),
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": byts,
        "collective_bytes_per_chip": coll.total_bytes,
        "collective_counts": coll.counts,
        "collective_bytes_by_kind": coll.operand_bytes,
        "chips": chips,
        "memory": mem,
        "fits_hbm": mem["peak_bytes"] <= HW["hbm_bytes"],
        **raw,
        "scan_corrected": False,
    }
    if model_flops is not None:
        out["model_flops"] = model_flops
        hlo_total = flops * chips
        out["useful_flops_fraction"] = (model_flops / hlo_total
                                        if hlo_total else 0.0)
        out["mfu_bound"] = (model_flops / HW["peak_flops"] / chips
                            / max(out["bound_s"], 1e-30))
    return out


def format_roofline(name: str, r: dict[str, Any]) -> str:
    lines = [f"[{name}] chips={r['chips']}",
             f"  compute    {r['compute_s']*1e3:10.3f} ms"
             f"  ({r['hlo_flops_per_chip']/1e12:.2f} TFLOP/chip)",
             f"  memory     {r['memory_s']*1e3:10.3f} ms"
             f"  ({r['hlo_bytes_per_chip']/1e9:.2f} GB/chip)",
             f"  collective {r['collective_s']*1e3:10.3f} ms"
             f"  ({r['collective_bytes_per_chip']/1e9:.3f} GB/chip)",
             f"  dominant: {r['dominant']}  bound: "
             f"{r['bound_s']*1e3:.3f} ms"]
    if "useful_flops_fraction" in r:
        lines.append(f"  MODEL/HLO flops: {r['useful_flops_fraction']:.3f}"
                     f"   MFU-bound: {r.get('mfu_bound', 0):.3f}")
    if r.get("memory"):
        lines.append(f"  mem/chip: args {r['memory']['argument_bytes']/1e9:.2f} GB"
                     f" + temp {r['memory']['temp_bytes']/1e9:.2f} GB"
                     f"  fits80GB={r['fits_hbm']}")
    return "\n".join(lines)
