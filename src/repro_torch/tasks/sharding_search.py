"""SHARDING-SEARCH O-task — the platform-specific optimization knob: the
port of the JAX package's ``tasks/sharding_search.py``.

No FPGA analogue exists: on a mesh of accelerators the expert-tuned knob
is the parallelism layout.  This O-task automates it the way PRUNING
automates the sparsity knob: enumerate candidate configurations (remat
policy, microbatching, cache-sequence sharding axis, FSDP on/off), lower
and compile each (``launch/dryrun.py``: one rank's program counted on
``meta`` tensors), and keep the one minimizing the roofline bound with
the H100's constants.  Greedy coordinate descent — each knob is tried
against the incumbent.

objective:  minimize   max(compute_s, memory_s, collective_s)
constraint: fits HBM (peak bytes/chip <= ``HW["hbm_bytes"]``, 80 GB)
"""

from __future__ import annotations

from repro_torch.configs.base import SHAPES
from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.core.task import OTask, TaskError
from repro_torch.launch.roofline import HW, roofline


class ShardingSearch(OTask):
    n_in = 1
    n_out = 1
    defaults = {
        "shape": "train_4k",
        "multi_pod": False,
        "knobs": None,          # {name: [candidates]} override
        "require_fit": True,
        "verbose": True,
    }

    BASE = {"remat": None, "microbatches": 1, "cache_seq_axis": None,
            "fsdp": None}
    TRAIN_KNOBS = {
        "remat": ["dots", "full", "none"],
        "microbatches": [1, 2, 4],
        "fsdp": [None, True],
    }
    DECODE_KNOBS = {
        "cache_seq_axis": [None, "model", "data"],
    }

    def measure(self, arch: str, shape, multi_pod: bool,
                cfg_kw: dict) -> dict:
        """One probe: lower, compile and roofline ``cfg_kw``; the rules'
        fallbacks ride along under ``"fallbacks"``."""
        from repro_torch.launch.dryrun import _cell_model_flops, lower_cell
        lowered, mesh, _, aux = lower_cell(arch, shape, multi_pod=multi_pod,
                                           **cfg_kw)
        r = roofline(lowered.compile(), mesh,
                     model_flops=_cell_model_flops(arch, shape))
        return dict(r, fallbacks=aux["fallbacks"])

    def execute(self, meta: MetaModel, inputs):
        art = meta.model(inputs[0])
        if art.level != LEVEL_DNN or art.payload.kind != "lm":
            raise TaskError("ShardingSearch expects an LM DNN artifact")
        handle = art.payload
        shape = SHAPES[self.param(meta, "shape")]
        multi_pod = self.param(meta, "multi_pod")
        knobs = self.param(meta, "knobs")
        if knobs is None:
            knobs = dict(self.TRAIN_KNOBS if shape.kind == "train"
                         else self.DECODE_KNOBS)
        verbose = self.param(meta, "verbose")
        require_fit = self.param(meta, "require_fit")

        def measure(cfg_kw: dict) -> dict:
            r = self.measure(handle.name, shape, multi_pod, cfg_kw)
            meta.record("sharding_search.probe", config=dict(cfg_kw),
                        bound_s=r["bound_s"], dominant=r["dominant"],
                        fits=r.get("fits_hbm"),
                        fallbacks=r.get("fallbacks"))
            if verbose:
                print(f"  probe {cfg_kw}: bound={r['bound_s']*1e3:.2f}ms "
                      f"dom={r['dominant']} fits={r.get('fits_hbm')}")
            return r

        def score(r: dict) -> float:
            s = r["bound_s"]
            if require_fit and r.get("fits_hbm") is False:
                peak = r["memory"].get("peak_bytes", 0)
                s += 10.0 * max(0.0, peak / HW["hbm_bytes"] - 1.0)
            return s

        incumbent = dict(self.BASE)
        best_r = measure(incumbent)
        trace = [{"config": dict(incumbent), "roofline": best_r}]
        for knob, candidates in knobs.items():
            for cand in candidates:
                if cand == incumbent.get(knob):
                    continue
                trial = dict(incumbent, **{knob: cand})
                try:
                    r = measure(trial)
                except Exception as e:  # noqa: BLE001
                    meta.record("sharding_search.error",
                                config=trial, error=repr(e))
                    continue
                trace.append({"config": dict(trial), "roofline": r})
                if score(r) < score(best_r):
                    incumbent, best_r = trial, r
        metrics = {"best_config": incumbent,
                   "bound_s": best_r["bound_s"],
                   "dominant": best_r["dominant"],
                   "n_probes": len(trace)}
        out_handle = handle.child(
            meta=dict(handle.meta, sharding_config=incumbent))
        out = meta.add_model(f"{handle.name}+Sh", LEVEL_DNN, out_handle,
                             parent=inputs[0],
                             metrics={**art.metrics, **metrics})
        meta.set("sharding_search.result",
                 {"best": incumbent, "roofline": best_r, "trace": trace})
        return [out]
