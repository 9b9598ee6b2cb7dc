"""Harness smoke tests: validation suite (condensed), convergence probe
semantics, search machinery, CLI plumbing, debug printers."""

import numpy as np
import jax.numpy as jnp
import pytest

import clover_tpu as ct
from clover_tpu.harness import search, validate
from clover_tpu.harness.search import SearchProblem, _trace_verdict
from clover_tpu.models import problems
from clover_tpu.utils.debug import compare, format_blocks, format_qvec


def test_trace_verdict_semantics():
    # converges: improvement dries up below 0.001 at a loss < 2
    tr = np.array([1.5, 0.8, 0.5, 0.4995, 0.49949], np.float32)
    r = _trace_verdict(tr)
    assert r.convergent and abs(r.quality - 0.4995) < 1e-6 and r.n_iter == 4
    # NaN anywhere -> divergent
    assert not _trace_verdict(np.array([1.0, np.nan, 0.1])).convergent
    # flat but above the loss bound -> divergent
    assert not _trace_verdict(np.array([3.0, 2.9999, 2.99985])).convergent
    # monotone descent to the end -> quality is the final loss
    r = _trace_verdict(np.array([2.0, 1.0, 0.5], np.float32))
    assert r.convergent and abs(r.quality - 0.5) < 1e-6


def test_search_problem_probe_and_iterations():
    phi, x_star, y = problems.make_iht_problem(128, 256, 16)
    prob = SearchProblem(phi, y, x_star, 4, 4, k=16, iteration_limit=30)
    good = prob.probe(3e-3)
    bad = prob.probe(0.5)          # way past the convergence boundary
    assert good.convergent
    assert not bad.convergent
    it = prob.iterations_to(3e-3, quality_target=good.quality / 0.98)
    assert 0 <= it <= 30


@pytest.mark.parametrize("mat_bits,vec_bits",
                         [(4, 8), (8, 8), (16, 16), (32, 32)])
def test_search_problem_all_precisions(mat_bits, vec_bits):
    """The per-precision columns of the reference's -g
    (00_search.cpp:229-238) need SearchProblem at every precision."""
    phi, x_star, y = problems.make_iht_problem(128, 256, 16)
    prob = SearchProblem(phi, y, x_star, mat_bits, vec_bits, k=16,
                         iteration_limit=20)
    r = prob.probe(3e-3)
    assert r.convergent and np.isfinite(r.quality)
    it = prob.iterations_to(3e-3, quality_target=r.quality / 0.98)
    assert 0 <= it <= 20


def test_gd_find_best_n_iterations():
    phi, x_star, y = problems.make_gd_problem(96, 64)
    prob = SearchProblem(phi, y, x_star, 8, 8, k=0, iteration_limit=25)
    q, mu = search.gd_best_possible_quality(prob, 0.1, 0.5, 0.1)
    it, mu_b = search.gd_find_best_n_iterations(
        prob, q / 0.9, lo=0.1, hi=0.5, precision=0.1)
    assert 0 <= it <= 25 and 0.1 <= mu_b <= 0.5


def test_iht_best_quality_small():
    phi, x_star, y = problems.make_iht_problem(128, 256, 16)
    prob = SearchProblem(phi, y, x_star, 4, 4, k=16, iteration_limit=30)
    q, mu, it = search.iht_best_possible_quality(
        prob, lo=1e-4, hi=0.05, precision=1e-3)
    assert q < 2.0 and 1e-4 <= mu <= 0.05 and 1 <= it <= 30


def test_validator_condensed():
    ok = validate.run_validation(full=False, log=lambda *_: None)
    assert ok


def test_cli_help_and_accuracy_smoke(capsys):
    from clover_tpu.cli import main
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "validation" in out or "validate" in out


def test_debug_printers():
    q = ct.quantize(jnp.asarray(np.linspace(-1, 1, 200, dtype=np.float32)), 4)
    s = format_qvec(q, max_elems=8)
    assert "code" in s and "scale" in s
    c = compare([1, 2, 3], [1, 9, 3])
    assert "mismatch" in c
    assert "[     0]" in format_blocks(np.arange(32))


class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


def test_peaks_known_device():
    from clover_tpu.harness.timing import peaks
    p = peaks(_Dev("NVIDIA H200"))
    assert p.hbm_bytes_per_s == 4.8e12
    assert p.bf16_flops == 989e12 and p.int8_ops == 1979e12
    assert "H200" in p.source


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "cpu", ""])
def test_peaks_unknown_device_raises(kind):
    """No assumed peak: a roofline share needs a published one."""
    from clover_tpu.harness import timing
    with pytest.raises(KeyError, match="no published peaks"):
        timing.peaks(_Dev(kind))


def test_roofline_share_on_cpu_raises():
    """The default device here is the host CPU, which has no table entry."""
    from clover_tpu.harness import timing
    with pytest.raises(KeyError, match="no published peaks"):
        timing.pct_roofline(1 << 20, 1e-3)


def test_compile_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, enable() keeps it and the
    compiled entries land there and nowhere else."""
    import os
    import subprocess
    import sys
    env_dir = tmp_path / "jaxcache"
    fallback = tmp_path / "fallback"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from clover_tpu.utils.compcache import enable\n"
        f"print(enable({str(fallback)!r}))\n"
        # a host compile this small is quicker than enable()'s threshold
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda v: jnp.cumsum(jnp.sin(v) * 3.0))("
        "jnp.arange(4096.0)).block_until_ready()\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(env_dir))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == str(env_dir)
    assert any(env_dir.iterdir())
    assert not fallback.exists()


def test_checkpoint_roundtrip(tmp_path):
    from clover_tpu.utils import checkpoint
    q = ct.quantize(jnp.asarray(np.linspace(-1, 1, 256, dtype=np.float32)), 4)
    state = {"x": q, "step": jnp.int32(7)}
    path = str(tmp_path / "ck")
    checkpoint.save(path, state)
    back = checkpoint.load(path, like=state)
    assert np.array_equal(np.asarray(back["x"].codes), np.asarray(q.codes))
    assert np.array_equal(np.asarray(back["x"].scales), np.asarray(q.scales))
    assert back["x"].length == 256 and int(back["step"]) == 7
