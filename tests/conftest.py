"""Test config: by default run everything on a simulated 8-device CPU mesh.

Mirrors the reference's validation philosophy (SIMD vs scalar golden on
one machine, test/validate/*): sharded-op tests use XLA's host-platform
device simulation.  Tests marked ``gpu`` check the compiled Triton kernel
and skip unless JAX runs on a GPU; run them on a GPU machine with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

# Must be set before jax initializes its backends.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
# IEEE-exact fp on the CPU backend so deterministic-mode quantization is
# bit-exact against the NumPy golden (XLA CPU fast-math turns f32 division
# into a 1-ulp-off reciprocal multiply).
if "xla_cpu_enable_fast_math" not in flags:
    flags += " --xla_cpu_enable_fast_math=false"
os.environ["XLA_FLAGS"] = flags.strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(445560390295639063 % (2**32))


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """``@pytest.mark.gpu`` tests run the compiled kernel, which has no
    CPU form; they skip unless JAX's default backend is a GPU."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs a GPU: runs the compiled Triton kernel")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Release compiled executables between test modules: one process
    cannot hold the whole suite's distinct XLA CPU executables — LLVM's
    JIT code arena exhausts after ~6k compiles (segfault inside
    compile_or_get_cached; the same failure mode forced the full
    validation sweep to be chunked across processes)."""
    yield
    jax.clear_caches()
