"""Hyper-parameter (mu) search: the reference's `-g` grid-search machinery
(test/performance/03_iht_gd_util.h) re-created for jitted solves.

Key design change vs the reference: convergence probes do NOT early-stop a
device loop.  The solver runs its full fixed-length scan (one compiled
program, reused for every mu because mu is a traced argument), and the
early-stopping semantics of ``is_IHT_or_GD_convergent`` (:120-204) are
applied to the returned loss trace on the host — identical verdicts, no
recompilation per probe, and the whole search amortizes one compile.

Semantics preserved from the reference:
* probe: walk the loss trace ||x_i - x*||/||x*||; stop at the first step
  with 0 <= improvement < 0.001; NaN => divergent; convergent iff the
  stop-loss < 2; quality = stop-loss (:171-204).
* IHT_best_possible_quality (:448-628): binary-search the largest
  convergent mu in [lo, hi], then repeat 10-point grid refinement between
  the two best grid points until the bracket is tighter than `precision`.
* GD_best_possible_quality (:206-276): linear sweep lo -> hi by
  `precision`, stop at first divergence.
* find_best_n_iterations (:278-446, :630-795): over the same grids, the
  fewest iterations reaching a quality target.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from ..formats import QVec32
from ..models import problems, solvers
from ..ops import quantize_mat, quantize_vec, transpose

ITERATION_LIMIT = 50
IMPROVEMENT_EPS = 0.001
CONVERGENCE_LOSS_BOUND = 2.0
GRID_SIZE = 10


@dataclasses.dataclass
class ProbeResult:
    convergent: bool
    quality: float          # loss at the early-stop point (inf if divergent)
    n_iter: int             # steps taken to the early-stop point


def _trace_verdict(trace: np.ndarray) -> ProbeResult:
    """Apply the reference's early-stopping walk to a full loss trace."""
    prev = np.inf
    stop_i = len(trace) - 1
    curr = float(trace[-1]) if len(trace) else np.inf
    for i, curr_i in enumerate(np.asarray(trace, np.float64)):
        if math.isnan(curr_i) or math.isinf(curr_i):
            return ProbeResult(False, float("inf"), len(trace))
        improvement = prev - curr_i
        prev = curr_i
        if 0 <= improvement < IMPROVEMENT_EPS:
            stop_i, curr = i, float(curr_i)
            break
        stop_i, curr = i, float(curr_i)
    if math.isnan(curr) or not curr < CONVERGENCE_LOSS_BOUND:
        return ProbeResult(False, float("inf"), stop_i + 1)
    return ProbeResult(True, curr, stop_i + 1)


class SearchProblem:
    """A quantized (Phi, y, x*) instance with cached compiled solvers."""

    def __init__(self, phi32, y32, x_star32, mat_bits: int, vec_bits: int,
                 k=None, key=None, iteration_limit: int = ITERATION_LIMIT):
        self.qphi = quantize_mat(phi32, mat_bits, key=key)
        self.qphit = transpose(self.qphi)
        self.qy = quantize_vec(y32, vec_bits, key=key)
        self.x_star = QVec32(
            values=jnp.pad(jnp.asarray(x_star32),
                           (0, self.qphi.cols_pad - len(x_star32))),
            length=self.qphi.cols)
        self.k = k
        self.key = key
        self.iteration_limit = iteration_limit

    def probe(self, mu: float, k=None) -> ProbeResult:
        k = self.k if k is None else k
        fn = solvers.iht if k else solvers.gd
        kwargs = {"k": int(k)} if k else {}
        res = fn(self.qphi, self.qphit, self.qy, self.iteration_limit,
                 mu=float(mu), key=self.key, x_star=self.x_star, **kwargs)
        return _trace_verdict(np.asarray(res.trace))

    def iterations_to(self, mu: float, quality_target: float) -> int:
        """determine_IHT_or_GD_iterations (:52-118): first step reaching
        the target, or the limit on NaN/failure."""
        fn = solvers.iht if self.k else solvers.gd
        kwargs = {"k": int(self.k)} if self.k else {}
        res = fn(self.qphi, self.qphit, self.qy, self.iteration_limit,
                 mu=float(mu), key=self.key, x_star=self.x_star, **kwargs)
        tr = np.asarray(res.trace)
        if np.any(np.isnan(tr)):
            return self.iteration_limit
        hits = np.nonzero(tr <= quality_target)[0]
        return int(hits[0]) if len(hits) else self.iteration_limit


def iht_best_possible_quality(problem: SearchProblem, lo: float = 1e-6,
                              hi: float = 0.5, precision: float = 1e-6,
                              log=lambda *_: None):
    """-> (best_quality, best_mu, best_n_iter)."""
    first = problem.probe(lo)
    if not first.convergent:
        raise RuntimeError(f"IHT does not converge at mu={lo}; "
                           "this should never happen (ref :512-516)")
    best_q, best_mu, best_it = first.quality, lo, first.n_iter
    lo_initial = lo

    # binary search the convergence boundary
    ub_found = False
    while lo + precision <= hi:
        mu = (lo + hi) / 2
        r = problem.probe(mu)
        log(f"mu={mu:.10f}: {'OK  ' if r.convergent else 'Fail'} | "
            f"quality {r.quality:.6f} | iters {r.n_iter}")
        if r.convergent:
            lo = mu
            ub_found = True
            if r.quality < best_q:
                best_q, best_mu, best_it = r.quality, mu, r.n_iter
        else:
            hi = mu
    if not ub_found:
        raise RuntimeError("upper bound not found (ref :566-569)")

    # 10-point grid, repeatedly refined between the two best points.
    # Unlike the reference (which can spin when the two best points are the
    # bracket endpoints), cap the rounds and bail if the bracket stalls.
    lo = lo_initial
    rounds = 0
    while lo + precision <= hi and rounds < 24:
        rounds += 1
        prev_span = hi - lo
        step = (hi - lo) / GRID_SIZE
        quals = []
        for i in range(GRID_SIZE + 1):
            mu = lo + step * i
            r = problem.probe(mu)
            log(f"mu={mu:.10f}: {'OK  ' if r.convergent else 'Fail'} | "
                f"quality {r.quality:.6f} | iters {r.n_iter}")
            quals.append(r.quality if r.convergent else np.inf)
            if r.convergent and r.quality < best_q:
                best_q, best_mu, best_it = r.quality, mu, r.n_iter
        order = np.argsort(quals)
        i1, i2 = int(order[0]), int(order[1])
        hi = lo + step * max(i1, i2)
        lo = lo + step * min(i1, i2)
        log(f"readjustment: {lo} - {hi}")
        if hi - lo >= prev_span * 0.95:     # stalled bracket
            break
    return best_q, best_mu, best_it


def gd_best_possible_quality(problem: SearchProblem, lo: float,
                             hi: float, precision: float,
                             log=lambda *_: None):
    """Linear sweep; stop at the first divergent mu (ref :206-276)."""
    first = problem.probe(lo, k=0)
    if not first.convergent:
        raise RuntimeError(f"GD does not converge at mu={lo}")
    best_q, best_mu = first.quality, lo
    mu = lo + precision
    while mu < hi:
        r = problem.probe(mu, k=0)
        if not r.convergent:
            break
        log(f"mu={mu:.10f}: quality {r.quality:.6f}")
        if r.quality < best_q:
            best_q, best_mu = r.quality, mu
        mu += precision
    return best_q, best_mu


def find_best_n_iterations(problem: SearchProblem, quality_target: float,
                           lo: float = 1e-6, hi: float = 0.5,
                           log=lambda *_: None):
    """Fewest iterations reaching the (relaxed) quality target over the
    refined mu grid (ref :278-446 / :630-795)."""
    best_it, best_mu = problem.iteration_limit, lo
    lo0 = lo
    # coarse boundary via binary search on convergence
    while lo + (hi - lo0) / 1e6 <= hi and hi - lo > 1e-6:
        mu = (lo + hi) / 2
        if problem.probe(mu).convergent:
            lo = mu
        else:
            hi = mu
    grid_hi, lo = hi, lo0
    step = (grid_hi - lo) / GRID_SIZE
    for i in range(GRID_SIZE + 1):
        mu = lo + step * i
        it = problem.iterations_to(mu, quality_target)
        log(f"mu={mu:.10f}: {it} iterations to target {quality_target:.4f}")
        if it < best_it:
            best_it, best_mu = it, mu
    return best_it, best_mu


def gd_find_best_n_iterations(problem: SearchProblem, quality_target: float,
                              lo: float = 0.1, hi: float = 0.5,
                              precision: float = 0.05,
                              log=lambda *_: None):
    """GD_find_best_n_iterations (ref 03_iht_gd_util.h:278-446): linear mu
    sweep lo..hi by `precision`; fewest iterations reaching the target."""
    best_it, best_mu = problem.iteration_limit, lo
    mu = lo
    while mu <= hi + 1e-12:
        it = problem.iterations_to(mu, quality_target)
        log(f"mu={mu:.10f}: {it} iterations to target {quality_target:.4f}")
        if it < best_it:
            best_it, best_mu = it, mu
        mu += precision
    return best_it, best_mu


# The reference's search driver size ladder (test/performance/00_test.cpp:
# 75-95, shared by -g via get_test_matrix_ops_sizes): 19 entries, 256 ->
# 32768.  IHT: m = size, n = 2m, K = n/4 (00_search.cpp:146-151); GD:
# n = size, m = 1.5n (00_search.cpp:63-66).
SIZE_LADDER = ([256, 512, 1024, 2048, 4096, 6144, 8192, 10240, 12288,
                14336, 16384, 18432, 20480, 22528, 24576, 26624, 28672,
                30720, 32768])
SEARCH_SIZES = [(256 << i, 512 << i) for i in range(5)]
# Default ladder for full regeneration runs: 12 sizes spanning the
# reference's range (the full 19 are one flag away via SIZE_LADDER).
SEARCH_SIZES_FULL = [256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096,
                     8192, 16384, 32768]

# The per-precision columns the reference tunes per size
# (00_search.cpp:229-238): the 4-bit (pure or mixed) config sets the
# quality target; 8/16/32-bit tune iterations to that target.
PRECISION_COLUMNS = [(8, 8), (16, 16), (32, 32)]


def run_search(sizes=None, mixed=False, gd=False, seed=None, log=print):
    """Single-family search (kept for the round-2 regeneration scripts):
    per size, best quality / mu / iterations for the pure 4-bit (or mixed
    4x8) configuration.  Returns (m, n, K, quality, mu, iterations) rows."""
    rows = []
    for (m, n) in sizes or SEARCH_SIZES:
        k = n // 4
        kwargs = {} if seed is None else {"seed": seed}
        if gd:
            phi, x_star, y = problems.make_gd_problem(m, n, **kwargs)
            prob = SearchProblem(phi, y, x_star, 4, 8 if mixed else 4, k=0)
            q, mu = gd_best_possible_quality(prob, 0.05, 0.95, 0.05, log=log)
            it = prob.iterations_to(mu, q / 0.98)
        else:
            phi, x_star, y = problems.make_iht_problem(m, n, k, **kwargs)
            prob = SearchProblem(phi, y, x_star, 4, 8 if mixed else 4, k=k)
            q, mu, it = iht_best_possible_quality(prob, log=log)
            # relax the target by 2% before tuning iterations (ref
            # 00_search.cpp:216)
            it, mu = find_best_n_iterations(prob, q / 0.98, log=log)
        rows.append((m, n, k, q, mu, it))
        log(f"size {m}x{n} K={k}: quality={q:.6f} mu={mu:.8f} iters={it}")
    return rows


def search_family(kind: str, size: int, seed=None, log=print):
    """One size of one family at the reference's full granularity
    (00_search.cpp:130-263): the 4-bit config (pure 4x4 or mixed 4x8)
    searches best quality, the target is relaxed (/0.98 IHT, /0.9 GD),
    then EVERY precision tunes (iterations, mu) to that target.

    ``kind``: "iht" | "iht_mixed" | "gd" | "gd_mixed".  Returns
    {"m", "n", "K", "quality_target", "cols": {4: (iters, mu), 8: ...,
    16: ..., 32: ...}}; a column that cannot run (e.g. fp32 at sizes
    whose Phi + PhiT exceed HBM) is recorded as None, never silently
    dropped.
    """
    gd = kind.startswith("gd")
    mixed = kind.endswith("mixed")
    kwargs = {} if seed is None else {"seed": seed}
    if gd:
        m, n = int(size * 1.5), size          # ref 00_search.cpp:63-66
        k = 0
        phi, x_star, y = problems.make_gd_problem(m, n, **kwargs)
    else:
        m, n = size, 2 * size                 # ref 00_search.cpp:146-151
        k = n // 4
        phi, x_star, y = problems.make_iht_problem(m, n, k, **kwargs)

    def build(mat_bits, vec_bits):
        return SearchProblem(phi, y, x_star, mat_bits, vec_bits, k=k)

    base = build(4, 8 if mixed else 4)
    if gd:
        q, mu0 = gd_best_possible_quality(base, 0.1, 0.5, 0.05, log=log)
        target = q / 0.9                      # ref 00_search.cpp:110-113
        it0, mu0 = gd_find_best_n_iterations(base, target, log=log)
    else:
        q, mu_q, it_q = iht_best_possible_quality(base, log=log)
        target = q / 0.98                     # ref 00_search.cpp:216
        it0, mu0 = find_best_n_iterations(base, target, log=log)
        if it_q < it0:                        # ref 00_search.cpp:240-247
            it0, mu0 = it_q, mu_q
    cols = {4: (it0, mu0)}
    for mat_bits, vec_bits in PRECISION_COLUMNS:
        try:
            prob = build(mat_bits, vec_bits)
            if gd:
                it, mu = gd_find_best_n_iterations(prob, target, log=log)
            else:
                it, mu = find_best_n_iterations(prob, target, log=log)
            cols[mat_bits] = (it, mu)
        except Exception as e:                # HBM etc. — record, don't hide
            log(f"  column {mat_bits}-bit SKIPPED at {m}x{n}: {e}")
            cols[mat_bits] = None
        finally:
            prob = None
    return {"m": m, "n": n, "K": k, "quality_target": float(target),
            "cols": cols}


def run_search_full(sizes=None, kinds=("gd", "iht", "gd_mixed", "iht_mixed"),
                    seed=None, log=print):
    """The reference's complete `-g` invocation (00_search.cpp:249-263):
    GD pure, IHT pure, GD mixed, IHT mixed — each per-size with all four
    precision columns.  Returns {kind: [search_family rows]}."""
    out = {}
    for kind in kinds:
        log(f"=== {kind} ===")
        out[kind] = []
        for size in sizes or SEARCH_SIZES_FULL:
            row = search_family(kind, size, seed=seed, log=log)
            c = ", ".join(
                f"{b}-bit: " + (f"iters={v[0]} mu={v[1]:.8f}" if v else "SKIP")
                for b, v in row["cols"].items())
            log(f"{kind} {row['m']}x{row['n']} K={row['K']} "
                f"target={row['quality_target']:.6f} | {c}")
            out[kind].append(row)
    return out
