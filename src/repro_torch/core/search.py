"""Search primitives used inside O-tasks.

The paper's auto-pruning (§V-B) is a binary search:

    maximize   pruning_rate
    subject to accuracy_loss(pruning_rate) <= alpha_p

"Starting at 0% pruning rate, the auto-pruning algorithm obtains initial
accuracy at step 1.  It then uses a binary search approach, increasing or
decreasing the pruning rate based on whether the accuracy loss is within a
user-defined tolerance (<= alpha_p).  The algorithm terminates when the rate
difference is below a threshold (beta_p).  The number of steps is determined
by 1 + log2(1/beta_p)."

These helpers are generic so that PRUNING, SCALING, QUANTIZATION,
SHARDING-SEARCH and TUNE all share the same machinery and the same
step-trace format (the TUNE task publishes its kernel-tuning trials in
it).  The port's copy of the JAX package's ``core/search.py``: pure
Python, the same searches step for step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence


@dataclasses.dataclass
class SearchStep:
    step: int
    x: Any
    objective: float
    feasible: bool
    info: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SearchResult:
    best_x: Any
    best_objective: float
    steps: list[SearchStep]

    @property
    def n_steps(self) -> int:
        return len(self.steps)


def binary_search_max(feasible: Callable[[float], tuple[bool, float, dict]],
                      lo: float = 0.0, hi: float = 1.0,
                      beta: float = 0.02) -> SearchResult:
    """Maximize x in [lo, hi] subject to ``feasible(x)``.

    ``feasible(x)`` returns ``(ok, objective, info)``.  Assumes feasibility is
    (approximately) monotone decreasing in x, as with pruning-rate vs accuracy.
    Terminates when the bracket width is below ``beta``; including the
    initial probe at ``lo`` the paper's step count is ``1 + log2(1/beta)``.
    """
    steps: list[SearchStep] = []

    ok0, obj0, info0 = feasible(lo)
    steps.append(SearchStep(1, lo, obj0, ok0, info0))
    best_x, best_obj = (lo, obj0) if ok0 else (None, -math.inf)

    # Probe the upper end first: if even hi is feasible we are done early.
    ok_hi, obj_hi, info_hi = feasible(hi)
    steps.append(SearchStep(2, hi, obj_hi, ok_hi, info_hi))
    if ok_hi:
        return SearchResult(hi, obj_hi, steps)

    lo_f, hi_i = lo, hi  # feasible lower bound, infeasible upper bound
    while hi_i - lo_f > beta:
        mid = 0.5 * (lo_f + hi_i)
        ok, obj, info = feasible(mid)
        steps.append(SearchStep(len(steps) + 1, mid, obj, ok, info))
        if ok:
            lo_f = mid
            if best_x is None or mid > best_x:
                best_x, best_obj = mid, obj
        else:
            hi_i = mid
    if best_x is None:
        best_x, best_obj = lo, obj0
    return SearchResult(best_x, best_obj, steps)


def monotone_shrink_search(candidates: Sequence[Any],
                           feasible: Callable[[Any], tuple[bool, float, dict]],
                           max_trials: int | None = None) -> SearchResult:
    """Walk ``candidates`` (ordered most→least aggressive shrink is NOT
    assumed; they are tried in order) and keep the last feasible one.

    Used by SCALING: candidates are successively smaller scale factors; the
    search stops at the first infeasible candidate (paper: "The search stops
    when the loss exceeds alpha_s").
    """
    steps: list[SearchStep] = []
    best_x, best_obj = None, -math.inf
    for i, x in enumerate(candidates):
        if max_trials is not None and i >= max_trials:
            break
        ok, obj, info = feasible(x)
        steps.append(SearchStep(len(steps) + 1, x, obj, ok, info))
        if not ok:
            break
        best_x, best_obj = x, obj
    return SearchResult(best_x, best_obj, steps)


def exhaustive_search(candidates: Sequence[Any],
                      evaluate: Callable[[Any], tuple[bool, float, dict]]
                      ) -> SearchResult:
    """Evaluate every candidate; keep the feasible one with the highest
    objective (ties: first seen wins).

    Used by the TUNE O-task: the candidate space is already pruned by the
    autotuner's divisibility/shared-memory constraints, so the search is a flat sweep
    with ``objective = -latency_us`` — each measured tile config becomes one
    :class:`SearchStep` in the MetaModel history, same as a pruning probe.
    """
    steps: list[SearchStep] = []
    best_x, best_obj = None, -math.inf
    for x in candidates:
        ok, obj, info = evaluate(x)
        steps.append(SearchStep(len(steps) + 1, x, obj, ok, info))
        if ok and obj > best_obj:
            best_x, best_obj = x, obj
    return SearchResult(best_x, best_obj, steps)


def staged_search(candidates: Sequence[Any],
                  stage1: Callable[[Any], tuple[bool, float, dict]],
                  stage2: Callable[[Any], tuple[bool, float, dict]],
                  *, keep: int | None = None, keep_frac: float = 0.5,
                  must_keep: Sequence[int] = ()) -> SearchResult:
    """Two-stage pruned sweep (SERVE O-task; uptune's intermediate-feature
    idiom).

    Every candidate first runs ``stage1`` — a cheap proxy evaluation whose
    info dict carries intermediate features — and only the top ``keep``
    stage-1 survivors (feasible ones, ranked by stage-1 objective) pay for
    the expensive ``stage2`` evaluation.  ``keep`` defaults to
    ``ceil(keep_frac * len(candidates))``; indices in ``must_keep`` are
    promoted to stage 2 unconditionally (the SERVE task pins its
    hand-assembled default plan there so the searched winner is gated
    against it on equal, stage-2 footing).

    The step trace covers both stages (``info["stage"]`` ∈ {1, 2});
    pruned candidates appear only as their stage-1 step.  The winner is
    the feasible stage-2 candidate with the highest stage-2 objective
    (ties: first seen wins).
    """
    steps: list[SearchStep] = []
    scores: list[tuple[int, bool, float]] = []
    for i, x in enumerate(candidates):
        ok, obj, info = stage1(x)
        steps.append(SearchStep(len(steps) + 1, x, obj, ok,
                                {**info, "stage": 1}))
        scores.append((i, ok, obj))
    if keep is None:
        keep = max(1, math.ceil(keep_frac * len(scores)))
    ranked = sorted((s for s in scores if s[1]),
                    key=lambda s: -s[2])
    survivors = [i for i, _, _ in ranked[:keep]]
    for i in must_keep:
        if i not in survivors and 0 <= i < len(scores):
            survivors.append(i)
    survivors.sort()

    best_x, best_obj = None, -math.inf
    for i in survivors:
        x = candidates[i]
        ok, obj, info = stage2(x)
        steps.append(SearchStep(len(steps) + 1, x, obj, ok,
                                {**info, "stage": 2, "candidate": i}))
        if ok and obj > best_obj:
            best_x, best_obj = x, obj
    return SearchResult(best_x, best_obj, steps)


def greedy_lattice_descent(items: Sequence[str],
                           levels: Sequence[Any],
                           accept: Callable[[dict[str, Any]], tuple[bool, float, dict]],
                           start_level: Any,
                           passes: int = 1) -> tuple[dict[str, Any], SearchResult]:
    """Greedy per-item precision descent (QUANTIZATION O-task).

    Every item (layer) starts at ``start_level``.  For each pass, for each
    item, try moving it one step down the ``levels`` lattice (ordered from
    most to least precise); keep the move iff ``accept(assignment)`` holds.
    Mirrors the paper's iterative per-layer mixed-precision loop: "If the
    accuracy loss is within tolerance (< alpha_q), this process is repeated."
    """
    assignment = {it: start_level for it in items}
    order = {lv: i for i, lv in enumerate(levels)}
    steps: list[SearchStep] = []
    best_obj = -math.inf

    for _ in range(passes):
        changed = False
        for it in items:
            cur = assignment[it]
            idx = order[cur]
            if idx + 1 >= len(levels):
                continue
            trial = dict(assignment)
            trial[it] = levels[idx + 1]
            ok, obj, info = accept(trial)
            steps.append(SearchStep(len(steps) + 1,
                                    {it: str(levels[idx + 1])}, obj, ok, info))
            if ok:
                assignment = trial
                best_obj = obj
                changed = True
        if not changed:
            break
    return assignment, SearchResult(dict(assignment), best_obj, steps)
