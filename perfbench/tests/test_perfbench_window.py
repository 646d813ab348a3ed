"""Window arithmetic on hand-made stamps: rates over all the work and
all the time of the window, tails over every request in it."""

import types

import numpy as np
import pytest

import perfbench_smoke as S  # noqa: F401  (puts the repo on sys.path)
from perfbench.harness.serve import Boundary, Sent, percentile
from perfbench.harness.window import (RunRecord, attempted_failed,
                                      end_to_end, tpots_s, ttfts_s)


def _req(prompt_len, t_done=None, failure=None):
    return types.SimpleNamespace(prompt_len=prompt_len, t_done=t_done,
                                 failure=failure, tokens=[])


def _sent(due, send, admit, shared, prompt_len, times, done=None,
          failure=None):
    s = Sent(req=_req(prompt_len, done, failure), t_due=due, t_send=send)
    s.t_admit, s.shared, s.token_times = admit, shared, list(times)
    return s


def _rec(sent, w0=10.0, w1=20.0):
    return RunRecord(config={}, segment_len=8, w0=w0, w1=w1, sent=sent,
                     boundaries=[])


def test_rate_counts_only_the_window_and_divides_by_all_of_it():
    sent = [
        # admitted before the window: its prompt does not count, its
        # tokens inside the window do
        _sent(8.0, 8.0, 9.0, 0, 100, [9.0, 10.5, 11.0], done=11.0),
        # admitted inside, 64 of 100 prompt tokens from the prefix cache
        _sent(12.0, 12.0, 12.5, 64, 100, [12.5, 13.0, 21.0]),
        # after the window
        _sent(20.5, 20.5, 21.0, 0, 50, [21.0]),
    ]
    e = end_to_end(_rec(sent), setup_s=3.0)
    assert e["tokens_per_s"] == pytest.approx((36 + 2 + 2) / 10.0)
    # one request completed inside the window
    assert e["requests_per_s"] == pytest.approx(1 / 10.0)
    assert e["setup_s"] == 3.0


def test_ttft_is_from_due_time_and_over_every_request():
    sent = [_sent(10.0 + i, 10.5 + i, 11.0 + i, 0, 10, [11.0 + i + 0.1 * i])
            for i in range(9)]
    got = sorted(ttfts_s(_rec(sent)))
    want = sorted(1.0 + 0.1 * i for i in range(9))
    assert got == pytest.approx(want)
    assert percentile(ttfts_s(_rec(sent)), 90) == pytest.approx(
        np.percentile(np.asarray(want), 90))


def test_tpot_and_failures():
    sent = [_sent(10.0, 10.0, 10.2, 0, 10, [10.2, 10.6, 11.0, 11.4],
                  done=11.4),
            _sent(10.0, 10.0, 10.2, 0, 10, [10.2, 12.2], done=12.2),
            _sent(11.0, 11.0, None, 0, 10, [], done=None, failure="dead"),
            _sent(25.0, 25.0, None, 0, 10, [], failure="dead")]
    assert sorted(tpots_s(_rec(sent))) == pytest.approx([0.4, 2.0])
    assert attempted_failed(_rec(sent)) == (3, 1)


def test_percentile_and_per_boundary_metrics():
    assert percentile([], 95) is None
    assert percentile([1.0, 2.0], 50) == 1.5
    bs = [Boundary(0.0, 1.0, [(0, 500)], [[(0, 500)]], [(501, 8)], 0.05,
                   0.4, 1, 1, 24),
          Boundary(1.0, 2.0, [], [], [(509, 8)], 0.0, 0.4, 1, 0, 192)]
    rec = RunRecord(config={}, segment_len=8, w0=0.0, w1=2.0, sent=[],
                    boundaries=bs)
    from perfbench.harness.spec import metric_reader
    assert metric_reader("prefill_ms_per_ktok.closed")(rec) == \
        pytest.approx(100.0)
    assert metric_reader("decode_step_ms.open")(rec) == pytest.approx(50.0)
    assert metric_reader("moe_host_syncs_per_fwd")(rec) == \
        pytest.approx(216 / 17)
    assert metric_reader("device_idle_frac.closed")(rec) is None
