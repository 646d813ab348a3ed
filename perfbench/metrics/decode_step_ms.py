"""Host time of the window's decode segments (``EngineRun`` ``decode_s``,
each ended by its one device-to-host read) per decode step
(``PagedServingEngine._segment``)."""


def read(rec):
    steps = sum(b.n_segments for b in rec.boundaries) * rec.segment_len
    secs = sum(b.decode_s for b in rec.boundaries)
    return secs * 1e3 / steps if steps else None
