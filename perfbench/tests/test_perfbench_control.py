"""The control at smoke size: the port's own FP8 path (one precision
below the configurations' bf16) reads the sound run's prompts and served
tokens, and must read at least three times what the sound program does
on the number each configuration compares.  On the chip
``perfbench/control.py`` reads the same at the cells' own sizes."""

import pytest

import perfbench_smoke as S
from perfbench.harness.cell import run_cell

CELLS = [w["name"] for w in S.bench()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_three_times_the_sound_program(name):
    cell = S.smoke_cell(name)
    out = run_cell(cell, 3, 0.8, False, device="cpu", control=True,
                   log=lambda m: None)
    r = out["readings"]
    assert out["correct"], out["checks"]
    for number in cell.config["correct"]["limits"]:
        assert r["control_" + number] >= 3 * r[number], r
