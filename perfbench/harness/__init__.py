"""The benchmark's general code: cell lookup, traffic generation, the
served loop and its window, work counts, trace reduction and the
comparison that decides ``correct``.  Nothing here is specific to one
configuration, traffic mix or per-layer metric: those are files under
``perfbench/configs``, ``perfbench/traffic`` and ``perfbench/metrics``,
found by the names in ``BENCHMARK.json``."""
