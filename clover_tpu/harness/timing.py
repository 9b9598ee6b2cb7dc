"""Measurement protocol (the analog of lib/perf.cpp's fenced RDTSC).

The reference times with CPUID-fenced RDTSC, calibrated repetitions, and a
median of 15 (lib/perf.cpp:183-200, test/performance/01_measure.h:39-85).
Here: jit a dependent chain of k applications of the op, calibrate k so
one run spans ``target_s``, time whole runs on the host clock up to
``jax.block_until_ready`` and report the median per op.  Bandwidth =
bytes_touched / time, against the card's published peak from
:data:`PEAKS` (the analog of the Xeon's 25.6 GB/s DRAM bound).
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np

MEASURE_REPETITIONS = 7


@dataclasses.dataclass(frozen=True)
class Peaks:
    hbm_bytes_per_s: float
    bf16_flops: float
    int8_ops: float
    source: str


# Keyed by jax.Device.device_kind.  Dense rates, no sparsity, at the
# card's full power limit.
PEAKS = {
    "NVIDIA H200": Peaks(
        hbm_bytes_per_s=4.8e12, bf16_flops=989e12, int8_ops=1979e12,
        source="NVIDIA H200 Tensor Core GPU data sheet, SXM part"),
}


def peaks(device=None) -> Peaks:
    """Published peaks of ``device`` (default: the first device).  An
    accelerator that is not in :data:`PEAKS` is an error: there is no
    assumed peak."""
    device = device if device is not None else jax.devices()[0]
    kind = device.device_kind
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}; "
                       f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def median_time(fn, reps: int = MEASURE_REPETITIONS) -> float:
    """Median wall time of ``fn()``, each run ending in
    ``jax.block_until_ready`` on its result."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def chain_time(make_chain, k: int | None = None,
               reps: int = MEASURE_REPETITIONS,
               target_s: float = 0.04) -> float:
    """Per-op time of a k-long dependent chain, median over ``reps``.

    ``make_chain(k)`` returns a zero-arg callable that runs a k-long
    dependent chain of the op.  With ``k=None`` the chain length is
    calibrated so one run spans ~``target_s`` — the reference's
    calibrated-repetition protocol (test/performance/01_measure.h:62-70)
    — which makes the per-run launch cost negligible.
    """
    if k is None:
        f1 = make_chain(1)
        jax.block_until_ready(f1())                 # compile + warm
        est = max(median_time(f1, 3), 1e-7)
        k = int(min(max(1, target_s / est), 100_000))
    fk = make_chain(k)
    jax.block_until_ready(fk())                     # compile + warm
    return median_time(fk, reps) / k


def gbs(nbytes: int, dt: float) -> float:
    return nbytes / dt / 1e9


def pct_roofline(nbytes: int, dt: float) -> float:
    return 100.0 * nbytes / dt / peaks().hbm_bytes_per_s
