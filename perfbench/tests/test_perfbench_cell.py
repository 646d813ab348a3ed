"""Whole runs of the cells at smoke size on the CPU, below the look for a
chip: the result line's shape, and ``correct`` coming out false when the
timed path is broken underneath (a served token altered where it is
produced; a decode step that returns its state unchanged; half of the
batch left out of the decode step)."""

import pytest
import torch

import perfbench_smoke as S
from perfbench.harness.cell import run_cell

CELLS = [w["name"] for w in S.bench()["workloads"]]


def _run(cell, seed=20240601, trace=False, plant=None, seconds=0.6):
    return run_cell(cell, seed, seconds, trace, device="cpu", plant=plant,
                    log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("mix", ["own", "open"])
def test_sound_run(name, mix):
    """Each cell on its own mix at smoke size, and on an open loop (the
    harness's other loop, which ``perfbench/sweep.py`` drives)."""
    cell = S.smoke_cell(name, None if mix == "own" else S.SMOKE_OPEN)
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    # a loaded CPU may fall behind the open loop's schedule, so that no
    # request falls due inside a short window; the closed loop always
    # sends inside it
    assert out["failed"] == 0 and (out["attempted"] > 0 or mix == "open")
    m = out["metrics"]
    assert "setup_s" in m and ({"tokens_per_s", "requests_per_s"} & set(m))
    assert all(v["value"] > 0 for v in m.values())
    assert out["checks"]["compared_tokens"]["value"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(name):
    out = _run(S.smoke_cell(name), trace=True, seconds=1.5)
    assert out["correct"], out["checks"]
    names = {n.split(".")[0] for n in out["metrics"]}
    assert {"prefill_ms_per_ktok", "decode_step_ms", "model_mfu"} <= names
    # a CPU run has no device trace: its readers return nothing
    assert not any(n.endswith("_roofline") for n in names)
    assert "device_idle_frac" not in names
    assert ("moe_host_syncs_per_fwd" in names) == ("granite" in name)
    assert ("tpot_p90_ms" in names) == ("docqa" in name)
    assert ("prefix_hit_frac" in names) == ("docreuse" in name)


def _altered_token(engine):
    inner = engine._segment

    def segment(*a):
        out = list(inner(*a))
        out[4] = (out[4] + 1) % int(engine.model.cfg.vocab_size)
        return tuple(out)
    engine._segment = segment


def _state_unchanged(engine):
    inner = engine._segment

    def segment(params, cache, *a):
        lens = cache["seq_lens"].clone()
        out = list(inner(params, cache, *a))
        out[0] = dict(out[0], seq_lens=lens)
        return tuple(out)
    engine._segment = segment


def _half_batch(engine):
    model = engine.model
    inner = model.decode_step

    def decode_step(params, cache, tokens, ctx=None):
        logits, cache = inner(params, cache, tokens, ctx)
        if "prefill_lens" not in cache and tokens.shape[0] > 1:
            h = tokens.shape[0] // 2
            logits = torch.cat([logits[:h], logits[:tokens.shape[0] - h]])
        return logits, cache
    model.decode_step = decode_step


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged,
                                   _half_batch])
def test_broken_path_is_not_correct(fault):
    # answers over two segments or more, so a state left unchanged at a
    # segment's end shows in the next one
    mix = dict(S.SMOKE_MIX, answer_tokens={"dist": "uniform", "min": 12,
                                           "max": 20})
    cell = S.smoke_cell("qwen2-7b.docqa-closed", mix)
    out = _run(cell, plant=fault)
    assert not out["correct"]
    assert any(chk["value"] > chk["limit"]
               for name, chk in out["checks"].items()
               if name.endswith("logit_gap"))


def test_requests_in_flight_at_the_close_finish_for_the_comparison():
    """A window too short for any request to finish: those sent by the
    close finish untimed, and the comparison reads them."""
    out = _run(S.smoke_cell("qwen2-7b.docqa-closed"), seconds=0.01)
    assert out["correct"], out["checks"]
    assert out["checks"]["compared_tokens"]["value"] >= 1
