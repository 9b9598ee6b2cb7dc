"""System banner (the analog of lib/sysinfo.cpp:40-127: CPU brand,
compiler identity, OpenMP status -> here: JAX/backend/device identity)."""

from __future__ import annotations

import platform
import sys

import jax

from .timing import PEAKS


def banner() -> str:
    devs = jax.devices()
    kind = devs[0].device_kind if devs else "?"
    pk = PEAKS.get(kind)
    roof = (f"HBM {pk.hbm_bytes_per_s / 1e9:.0f} GB/s, "
            f"bf16 {pk.bf16_flops / 1e12:.0f} TFLOP/s ({pk.source})"
            if pk else "no published peaks for this device")
    lines = [
        "clover_tpu — block-scaled quantized linear algebra",
        f"python   : {sys.version.split()[0]} on {platform.platform()}",
        f"jax      : {jax.__version__}",
        f"backend  : {jax.default_backend()}",
        f"devices  : {len(devs)} x {kind}",
        f"roofline : {roof}",
    ]
    return "\n".join(lines)


def print_banner():
    print(banner())
