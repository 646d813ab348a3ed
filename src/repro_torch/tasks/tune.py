"""TUNE O-task: per-shape kernel launch-config search (kernels/autotune.py).

The FPGA MetaML tunes low-level HLS knobs (unroll factors, partitioning);
here the knobs are the launch configs of the port's CUDA kernels.  TUNE
closes the cross-stage loop: it inspects the DNN-level artifact, derives
the concrete kernel problems the model will execute (matmul shapes from
the weight matrices, the attention shape from the arch config,
block-sparse shapes from pruning masks), and runs the autotuner's
exhaustive search on each.  Every measured candidate is republished as a
``SearchStep`` in the MetaModel history — a tuning run reads exactly like
a PRUNING or QUANTIZATION run in the logs — and the winning configs are
attached to the output artifact (``handle.meta["tile_configs"]``) and to
the shared CFG (``tune.result``).  The JAX package's ``tasks/tune.py``,
with ``device`` (the card unless ``"cpu"``) in place of ``interpret``.

Multiplicity 1-to-1 (paper Table I): the model itself is unchanged; the
output artifact is a child whose metadata carries the tuned configs.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.metamodel import LEVEL_DNN, MetaModel
from repro_torch.core.task import OTask
from repro_torch.tasks.handle import DNNHandle


class Tune(OTask):
    n_in = 1
    n_out = 1
    defaults = {
        "problems": "auto",      # "auto" | list of {"kernel":..., **problem}
        "batch_m": 128,          # synthetic M dim for matmul problems
        "max_problems": 4,       # cap on auto-derived problems (largest 1st)
        "max_trials": 16,        # per-problem candidate cap
        "iters": 3,              # timing iterations per candidate
        "warmup": 1,
        "cache_path": None,      # None -> autotune.default_cache_path()
        "force": False,          # re-measure even on a cache hit
        "device": None,          # None -> cuda; "cpu" times plain versions
    }

    def execute(self, meta: MetaModel, inputs):
        from repro_torch.kernels import autotune

        art = meta.model(inputs[0])
        handle: DNNHandle = art.payload
        device = self.param(meta, "device")
        problems = self.param(meta, "problems")
        if problems == "auto":
            problems = derive_problems(
                handle, batch_m=self.param(meta, "batch_m"),
                max_problems=self.param(meta, "max_problems"),
                device=device)
        meta.record("tune.start", task=self.name,
                    problems=[p["kernel"] for p in problems])

        tuned: dict[str, dict[str, int]] = {}
        metrics: dict[str, Any] = {}
        total_steps = 0
        for i, spec in enumerate(problems):
            spec = dict(spec)
            kernel = spec.pop("kernel")
            result = autotune.tune(
                kernel, spec,
                cache_path=self.param(meta, "cache_path"),
                force=self.param(meta, "force"),
                device=device,
                iters=self.param(meta, "iters"),
                warmup=self.param(meta, "warmup"),
                max_trials=self.param(meta, "max_trials"))
            # republish the search trace into the MetaModel history, one
            # probe event per measured launch config (cache hits are a
            # single zero-cost step, same shape as a pruning probe)
            if result.search is not None:
                for step in result.search.steps:
                    meta.record("tune.probe", kernel=kernel, key=result.key,
                                step=step.step, config=step.x,
                                us=step.info.get("us"),
                                smem_bytes=step.info.get("smem_bytes"),
                                smem_budget=step.info.get("smem_budget"),
                                feasible=step.feasible)
                total_steps += result.search.n_steps
            else:
                meta.record("tune.probe", kernel=kernel, key=result.key,
                            step=1, config=result.config, us=result.us,
                            cached=True, feasible=True)
                total_steps += 1
            tuned[result.key] = result.config
            # index-qualified: several problems may share a kernel
            metrics[f"tune.p{i}.{kernel}.us"] = result.us
            if result.default_us is not None:
                metrics[f"tune.p{i}.{kernel}.default_us"] = \
                    result.default_us
            meta.record("tune.done", kernel=kernel, key=result.key,
                        config=result.config, us=result.us,
                        cached=result.cached)

        out_handle = handle.child(
            meta={**handle.meta, "tile_configs": tuned})
        # carried parent metrics first: a chained second TUNE stage must
        # not have its fresh tune.* values shadowed by the stale carried
        # ones
        metrics = {**{k: v for k, v in art.metrics.items()
                      if isinstance(v, (int, float))},
                   **metrics,
                   "tune.problems": len(problems),
                   "tune.search_steps": total_steps}
        out = meta.add_model(f"{handle.name}+T", LEVEL_DNN, out_handle,
                             parent=inputs[0], metrics=metrics)
        meta.set("tune.result", {"configs": tuned,
                                 "search_steps": total_steps})
        return [out]


def derive_problems(handle: DNNHandle, *, batch_m: int = 128,
                    max_problems: int = 4,
                    device=None) -> list[dict[str, Any]]:
    """Concrete kernel problems this model's forward pass executes — the
    JAX package's list, letter for letter:

    - quant_matmul: one problem per distinct 2D weight shape (K, N) with
      both dims at least 32, activations (batch_m, K);
    - block_sparse_matmul: same shapes, for paths carrying a pruning mask
      at 128-block granularity (max_live read off the mask);
    - flash_attention: the arch config's (seq_len, heads, head_dim) when
      the handle wraps an LM;
    - flash_decode: one-token attention over the arch's decode cache;
    - flash_decode_paged, flash_prefill_ragged, paged_segment: the paged
      serving hot loop (linear caches only), keyed against the page size
      the default cache (:func:`autotune.default_cache_path`; the JAX
      package reads its own default) already holds for ``device``'s
      backend, whatever cache ``Tune`` tunes into.
    Largest problems first, capped at ``max_problems``.  An LM's per-layer
    matrices are 3-D stacked leaves in the path view, as in the JAX
    pytree, so they derive nothing.
    """
    from repro_torch.kernels import autotune
    from repro_torch.sparsity.masks import block_map, flatten_params

    sized: list[tuple[int, dict[str, Any]]] = []
    seen: set[str] = set()
    flat = flatten_params(handle.params)
    for path, w in flat.items():
        if getattr(w, "ndim", 0) != 2:
            continue
        k, n = int(w.shape[0]), int(w.shape[1])
        if k < 32 or n < 32:
            continue
        prob = autotune.quant_matmul_problem((batch_m, k), (k, n), w.dtype)
        key = autotune.cache_key("quant_matmul", prob)
        if key not in seen:
            seen.add(key)
            sized.append((k * n, {"kernel": "quant_matmul", **prob}))
        mask = (handle.masks or {}).get(path)
        if mask is not None and k % 128 == 0 and n % 128 == 0:
            occupancy = block_map(mask, 128)
            max_live = max(1, int(occupancy.sum(axis=0).max()))
            bprob = autotune.block_sparse_matmul_problem(
                (batch_m, k), (k, n), w.dtype, max_live=max_live)
            bkey = autotune.cache_key("block_sparse_matmul", bprob)
            if bkey not in seen:
                seen.add(bkey)
                sized.append((k * n,
                              {"kernel": "block_sparse_matmul", **bprob}))
    if handle.model is not None and getattr(handle.model.cfg,
                                            "n_heads", 0) > 0:
        cfg = handle.model.cfg
        hd = cfg.hd
        seq = min(int(getattr(cfg, "seq_len", 512) or 512), 512)
        prob = autotune.flash_attention_problem(
            (1, seq, cfg.n_heads, hd), (1, seq, cfg.n_kv_heads, hd),
            "float32", causal=True)
        sized.append((seq * seq * cfg.n_heads,
                      {"kernel": "flash_attention", **prob}))
        window = int(getattr(cfg, "sliding_window", 0) or 0)
        cache_len = min(seq, window) if window else seq
        # decode batch capped (the winning config is batch-invariant);
        # dtype is the arch's activation dtype
        db = min(batch_m, 8)
        adt = str(getattr(cfg, "act_dtype", "") or "float32")
        dprob = autotune.flash_decode_problem(
            (db, 1, cfg.n_heads, hd),
            (db, cache_len, cfg.n_kv_heads, hd), adt)
        # weighted like a full-cache prefill row so the serving hot loop
        # survives the max_problems cap alongside the big matmuls
        sized.append((seq * cache_len * cfg.n_heads,
                      {"kernel": "flash_decode", **dprob}))
        from repro_torch.serving.paged_cache import supports_paging
        if supports_paging(cfg):
            pprob = autotune.flash_decode_paged_problem(
                db, cfg.n_heads, cfg.n_kv_heads, hd, cache_len, adt)
            sized.append((seq * cache_len * cfg.n_heads,
                          {"kernel": "flash_decode_paged", **pprob}))
            # the admission prefill and the segment cadence are tuned
            # against the page size the default cache already holds (pure
            # read; the kernel default on a cold cache), as the JAX
            # package reads it
            pps = int(autotune.tile_readback(
                "flash_decode_paged", pprob, device=device)[0]["page_size"])
            sbucket = min(int(seq), 32)
            fprob = autotune.flash_prefill_ragged_problem(
                db, sbucket, cfg.n_heads, cfg.n_kv_heads, hd, cache_len,
                pps, adt)
            sized.append((seq * cache_len * cfg.n_heads,
                          {"kernel": "flash_prefill_ragged", **fprob}))
            gprob = autotune.paged_segment_problem(
                db, cfg.n_heads, cfg.n_kv_heads, hd, cache_len, pps, adt)
            sized.append((seq * cache_len * cfg.n_heads,
                          {"kernel": "paged_segment", **gprob}))
    sized.sort(key=lambda sp: -sp[0])
    return [p for _, p in sized[:max_problems]]
