"""The paged decode kernel's share of its roofline over the traced part
of the window: the least time of its launches (``work.py``: every layer
of every decode step, over the rows still decoding) over the device time
of its partial and combine kernels in the trace, in percent."""

from perfbench.harness import work as W


def read(rec):
    if rec.trace is None:
        return None
    dev = rec.trace["kernel_s"]["flash_decode_paged"]
    least = sum(W.decode_kernel_least_s(rec.config, b.decode_rows)
                for b in rec.traced)
    return 100.0 * least / dev if dev and least else None
