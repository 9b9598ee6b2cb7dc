"""Profiling / observability (SURVEY §5 tracing equivalent).

The reference's only introspection is the fenced RDTSC counter; here
``jax.profiler`` traces (viewable in TensorBoard/Perfetto) plus a roofline
accountant that pairs measured op times with the bytes each container op
must touch.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os

import jax

from .timing import gbs, pct_roofline


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a device trace around a block:

        with profile.trace("chiprun_out/trace"):
            run_step()
    """
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def device_op_times(logdir: str) -> dict:
    """Reduce the newest trace under ``logdir`` to device time per
    operation: {(plane, line): Counter(event name -> total ns)} over the
    device planes (``/device:...``).  Lines separate streams from the
    per-op and per-module views, so totals are read per line."""
    paths = sorted(glob.glob(os.path.join(logdir, "plugins", "profile",
                                          "*", "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    data = jax.profiler.ProfileData.from_file(paths[-1])
    out = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            c = out.setdefault((plane.name, line.name), collections.Counter())
            for ev in line.events:
                c[ev.name] += ev.duration_ns
    return out


def annotate(name: str):
    """Named region inside a trace (TraceAnnotation)."""
    return jax.profiler.TraceAnnotation(name)


def roofline_report(entries):
    """entries: [(name, nbytes, seconds)] -> formatted roofline table."""
    lines = [f"{'op':32s} {'time(ms)':>10} {'GB/s':>9} {'%HBM roof':>10}"]
    for (name, nbytes, dt) in entries:
        lines.append(f"{name:32s} {dt * 1e3:>10.4f} {gbs(nbytes, dt):>9.1f} "
                     f"{pct_roofline(nbytes, dt):>9.1f}%")
    return "\n".join(lines)
