"""Host reads of the MoE layers (``models/layers.py::moe_host_syncs``)
per forward over the window: per admission dispatch and decode step."""


def read(rec):
    fwd = sum(b.n_prefill_dispatches + b.n_segments * rec.segment_len
              for b in rec.boundaries)
    syncs = sum(b.moe_host_syncs for b in rec.boundaries)
    return syncs / fwd if fwd and syncs else None
