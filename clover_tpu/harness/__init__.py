"""Measurement, validation, accuracy, and hyper-parameter-search harness.

The re-creation of the reference's test/benchmark layers (SURVEY §L5/L6):
``lib/perf`` (timing), ``test/validate`` (-v), ``test/performance`` (-p),
``test/accuracy`` (-a), ``test/search`` (-g).  Entry point: clover_tpu.cli.
"""

from . import accuracy, perf, profile, search, sysinfo, timing, validate  # noqa: F401
