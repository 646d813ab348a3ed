"""Smoke-size stand-ins of the benchmark's cells for the CPU tests: the
same configuration files and mixes with widths, depth, vocabulary and
lengths cut so that a whole run takes seconds on the CPU."""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

from perfbench.harness.spec import find_cell, load_json  # noqa: E402

SMOKE_MODELS = {
    "qwen2-7b": dict(hidden_size=56, num_attention_heads=7,
                     num_key_value_heads=1, head_dim=8,
                     intermediate_size=96, vocab_size=256,
                     num_hidden_layers=2, torch_dtype="float32"),
    "granite-moe-1b-a400m": dict(hidden_size=64, num_attention_heads=4,
                                 num_key_value_heads=2,
                                 intermediate_size=64, num_local_experts=8,
                                 num_experts_per_tok=2, vocab_size=256,
                                 num_hidden_layers=2,
                                 attention_multiplier=0.25),
}
SMOKE_MIX = dict(loop="closed", clients=4, warmup_requests=4, block=16,
                 prompt_tokens={"dist": "loguniform", "min": 16, "max": 64},
                 answer_tokens={"dist": "uniform", "min": 4, "max": 8})
SMOKE_DOCS = dict(loop="closed", clients=4, warmup_requests=4, block=16,
                  documents={"count": 4, "zipf_s": 1.0,
                             "tokens": {"dist": "loguniform", "min": 32,
                                        "max": 64}},
                  question_tokens={"dist": "uniform", "min": 4, "max": 12},
                  answer_tokens={"dist": "uniform", "min": 4, "max": 8},
                  retain_documents=2)
SMOKE_OPEN = dict(SMOKE_DOCS, loop="open", rate_per_s=10.0)


def bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def smoke_config(name: str, **serving) -> dict:
    c = load_json(ROOT / "perfbench" / "configs" / f"{name}.json")
    c.update(SMOKE_MODELS[name])
    c["serving"] = dict(c["serving"], max_slots=4, **serving)
    return c


def smoke_cell(cell_name: str, mix: dict | None = None):
    """The cell of BENCHMARK.json at smoke size: its configuration cut as
    :data:`SMOKE_MODELS` says and its mix as ``mix`` (default: the smoke
    mix of the cell's kind, with or without documents)."""
    cell = find_cell(cell_name, bench(), ROOT)
    traffic = dict(cell.traffic)
    if mix is None:
        mix = SMOKE_DOCS if "documents" in traffic else SMOKE_MIX
    for k in ("prompt_tokens", "documents", "question_tokens",
              "rate_per_s", "clients"):
        traffic.pop(k, None)
    traffic.update(mix)
    return dataclasses.replace(cell, config=smoke_config(cell.config_name),
                               traffic=traffic)
