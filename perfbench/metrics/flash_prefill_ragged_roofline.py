"""The ragged prefill kernel's share of its roofline over the traced
part of the window: the least time of its launches (``work.py``: every
layer of every admission dispatch) over its device time in the trace,
in percent."""

from perfbench.harness import work as W


def read(rec):
    if rec.trace is None:
        return None
    dev = rec.trace["kernel_s"]["flash_prefill_ragged"]
    least = sum(W.prefill_kernel_least_s(rec.config, rows)
                for b in rec.traced for rows in b.dispatches)
    return 100.0 * least / dev if dev and least else None
