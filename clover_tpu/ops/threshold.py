"""Hard thresholding: keep the top-K elements by |value|, zero the rest.

Reference: CloverVector4.h:1913-2060 (min-heap streaming), ditto for 8/16/32.
Block scales are NOT updated (reference behavior: only ``setBits(i, 0)`` is
called; the scale array is untouched).  Ties break toward the lower index —
the reference's heap is order-dependent on ties, so we fix a deterministic
rule (its validation compares restored top-K sets at 10% tolerance,
test/validate/02_vector.cpp:449-554, which this satisfies).

Design: sort-free exact k-th-value bisection over the non-negative-float
bit ordering (the design dates from an accelerator whose sorts were
slow; whether a sort now wins is an open measurement).  4-bit compresses
the candidate multiset to per-(block, magnitude) counts built by
indicator matmuls; 8/16/32-bit bisect the elements directly.  Ties take a rank-free ``lax.cond`` fast path when they fit
the remaining slots exactly (the generic case).  The distributed version
(per-shard top-k + gathered merge) lives in clover_tpu.parallel — the
same two-phase algorithm as the reference's parallel heap merge
(CloverVector4.h:1975-2060) with the interconnect standing in for shared
memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats import (
    BLOCK, QVec4, QVec8, QVec16, QVec32, pack_nibbles, unpack_nibbles,
)
from .quantize import restore_vec


_CHUNK = 2048


def _top_k_idx(vals: jax.Array, k: int) -> jax.Array:
    """Indices of the top-k values; deterministic lower-index tie-break.

    Used by the sharded threshold merge (clover_tpu.parallel.ops), which
    needs shard-local INDICES to gather candidates across the mesh.  For
    large vectors a two-stage select (per-2048-chunk top-k, then top-k
    over the C*k candidates) replaces the full-length sort — the global
    top-k is always a subset of the per-chunk top-k's, and
    ``lax.top_k``'s stable ordering preserves the lower-index tie-break
    through both stages (candidates stay in (chunk, rank) order)."""
    npad = vals.shape[-1]
    if npad % _CHUNK or npad // _CHUNK < 4 or k > _CHUNK:
        _, idx = jax.lax.top_k(vals, k)
        return idx
    c = npad // _CHUNK
    pv, pi = jax.lax.top_k(vals.reshape(c, _CHUNK), k)     # (c, k)
    base = (jnp.arange(c, dtype=jnp.int32) * _CHUNK)[:, None]
    gidx = (pi.astype(jnp.int32) + base).reshape(-1)
    _, sel = jax.lax.top_k(pv.reshape(-1), k)
    return gidx[sel]


# Bisection fan-out (pivots per level + 1).  Sequential DEPTH is what
# matters — each level's count pass is throughput-cheap but its
# cross-lane reduce is ~us latency — so a wider fan with fewer levels
# should win as long as the wider compare stays throughput-cheap.
# _bisect_levels derives the guaranteed-exact depth for any fan.
BISECT_FAN = 9


def _bisect_levels(fan: int) -> int:
    """Levels guaranteeing exact resolution over the int32 bit range:
    each level leaves width <= floor(w/fan) + fan (remainder slack), so
    after ceil(log_fan(2^32)) levels the bracket is <= ~fan+1 wide; one
    step==1 level then covers fan-1 consecutive integers and one more
    resolves the remainder.  fan=9 -> 12 (the round-2 constant, verified
    by tests/test_ops.py::test_threshold_adjacent_bit_ties), fan=81 -> 7."""
    import math
    return math.ceil(math.log(2.0 ** 32) / math.log(fan)) + 2


def _tau_bisect(cand: jax.Array, counts: jax.Array, k: int,
                fan: int | None = None):
    """(tau_bits, n_above, n_eq): the bit pattern of the k-th largest
    element of the weighted candidate multiset (cand >= 0, f32), the
    count strictly above it, and the tie multiplicity at it.

    fan-way bisection on the non-negative-float bit ordering.  Each
    level evaluates fan-1 pivots at
    once (broadcast compare, independent reduces); depth per
    _bisect_levels.  If the multiset has fewer than k entries the result
    degenerates to tau_bits = 0 / keep-everything, which is correct for
    thresholding (only zero codes are added to the kept set).
    cand/counts may be any (equal) shape; they are reduced over all
    axes."""
    fan = BISECT_FAN if fan is None else fan
    bits = jax.lax.bitcast_convert_type(cand, jnp.int32)
    counts = counts.astype(jnp.int32)
    # materialize BEFORE the loop: without the barrier XLA fuses the
    # candidate/count computation into the while body and recomputes it
    # on every bisection step (measured 30x slowdown)
    bits, counts = jax.lax.optimization_barrier((bits, counts))
    axes = tuple(range(1, bits.ndim + 1))
    jf = jnp.arange(1, fan, dtype=jnp.int32)

    def body(_, lohi):
        lo, hi = lohi
        # evenly-stepped pivots in (lo, hi]; step*jf cannot overflow
        # (step <= (hi-lo)/fan) and max(step,1) guarantees progress at
        # small widths, where the clamp to hi keeps pivots in range
        step = jnp.maximum((hi - lo) // fan, 1)
        mids = jnp.minimum(lo + step * jf, hi)           # (fan-1,)
        m8 = mids.reshape((fan - 1,) + (1,) * bits.ndim)
        cj = jnp.sum(jnp.where(bits[None] > m8, counts[None], 0),
                     axis=axes)
        ge = cj >= k
        lo2 = jnp.max(jnp.where(ge, mids, lo))
        hi2 = jnp.min(jnp.where(ge, hi, mids))
        return lo2, hi2

    lo0 = jnp.int32(-1)
    hi0 = jnp.max(bits)          # k >= 1 => k-th largest <= multiset max
    _, tau = jax.lax.fori_loop(0, _bisect_levels(fan), body, (lo0, hi0))
    n_above = jnp.sum(jnp.where(bits > tau, counts, 0))
    n_eq = jnp.sum(jnp.where(bits == tau, counts, 0))
    return tau, n_above, n_eq


def _strict_upper(w: int) -> jax.Array:
    r = jax.lax.broadcasted_iota(jnp.int32, (w, w), 0)
    c = jax.lax.broadcasted_iota(jnp.int32, (w, w), 1)
    return jnp.where(r < c, 1.0, 0.0)


def _row_prefix_excl(m2: jax.Array) -> jax.Array:
    """(R, W) f32 int-valued -> exclusive prefix along rows, via one
    HIGHEST-precision triangular matmul (exact for sums < 2^24)."""
    w = m2.shape[-1]
    return jax.lax.dot(m2, _strict_upper(w),
                       precision=jax.lax.Precision.HIGHEST)


def _prefix_excl(v: jax.Array) -> jax.Array:
    """Exclusive prefix sum of an int-valued f32 vector (hierarchical
    128-wide triangular matmuls; exact while the total stays < 2^24)."""
    m = v.shape[0]
    if m <= 128:
        pad = 128 - m
        v2 = jnp.pad(v, (0, pad))[None, :]
        return _row_prefix_excl(v2)[0, :m]
    rows = -(-m // 128)
    v2 = jnp.pad(v, (0, rows * 128 - m)).reshape(rows, 128)
    intra = _row_prefix_excl(v2)
    off = _prefix_excl(jnp.sum(v2, axis=1))
    return (intra + off[:, None]).reshape(-1)[:m]


def _rank_tie_mask(gt, eq, fill):
    """gt-or-first-ties mask in golden order (|value| desc, index asc):
    tie ranks come from a per-64-block exclusive prefix (one triangular
    matmul) plus hierarchical cross-block offsets — no full-length
    cumsum.  Shared by the 4-bit wide-view and 8/16/32 dense slow
    paths."""
    eqf = eq.astype(jnp.float32).reshape(-1, BLOCK)
    intra = _row_prefix_excl(eqf)                      # (nb, 64)
    blk_off = _prefix_excl(jnp.sum(eqf, axis=1))       # (nb,)
    rank = (blk_off[:, None] + intra).reshape(eq.shape)
    return jnp.logical_or(
        gt, jnp.logical_and(eq, rank < fill.astype(jnp.float32)))


# Use the approx_max_k + exact-verification tau finder (instead of pure
# bisection) on the DENSE paths when k is at most this (the approx
# pass's cost grows with k; the bisection's 12 level scans each re-read
# the full f32 array).  The 4-bit wide-view path does NOT use it: its
# bisection scans the 8x-compressed candidate multiset.
TAU_HIER_MAX_K = 1024

# The 4-bit hybrid selector engages at and above this padded length.
HYBRID4_MIN_N = 1 << 19

# the hybrid's plane-structured selector gathers min(k, nb) scales and
# runs a (7k)^2 pairwise weighted count; past this k the quadratic stops
# paying and the compressed bisection selects instead
_HYBRID4_SEL_K = 256


def _tau_approx_verified(ev: jax.Array, k: int, fallback):
    """tau_bits of the EXACT k-th largest value of ``ev``, via a
    verified approximate candidate with a bisection fallback.

    ``jax.lax.approx_max_k`` (a partial-reduction top-k; its GPU
    lowering's speed is not measured yet) proposes tau = its k-th
    value.  One global count pass PROVES or refutes it: tau is exact
    iff count(> tau) < k <= count(>= tau).  A miss (the approx pass
    dropped a true top-k element; its k-th value is then too SMALL,
    never too large) fails the first inequality and ``lax.cond`` runs
    ``fallback`` (the exact bisection), so the result is exact on every
    input.  Padding is safe on both container layouts: 4-bit padding
    is 0.0 (only inflates the >= count, and only at tau == 0 where
    count(> 0) < k already decides exactness alone); dense padding is
    -1.0 (a negative bit pattern — if approx ever surfaces it, every
    real element counts above it and the check fails into the
    fallback).  (A block-max top_k hierarchy was tried first and
    measured SLOWER than the bisection — the k-row gather lowers to
    sequential dynamic slices.)"""
    topv = jax.lax.approx_max_k(ev.reshape(-1), k, recall_target=0.99)[0]
    tau_c = jax.lax.bitcast_convert_type(topv[k - 1], jnp.int32)
    ebits = jax.lax.bitcast_convert_type(ev, jnp.int32)
    n_above_c = jnp.sum((ebits > tau_c).astype(jnp.int32))
    n_ge_c = n_above_c + jnp.sum((ebits == tau_c).astype(jnp.int32))
    ok = jnp.logical_and(n_above_c < k, n_ge_c >= k)
    return jax.lax.cond(ok, lambda _: tau_c, fallback, None)


def _wide_cols(npad: int) -> int:
    """Element columns of the wide 2-D view (whole 64-blocks per row;
    npad is always a multiple of 128 so 128 always divides)."""
    for w in (1024, 512, 256, 128):
        if npad % w == 0:
            return w
    raise AssertionError(f"npad={npad} not a multiple of 128")


def _threshold4_xla(x, k: int):
    """4-bit XLA threshold: wide-view tau selection + mask.

    tau comes from the candidate-multiset bisection: per-(block,
    magnitude) counts from seven indicator bf16 matmuls (counts <= 64,
    exact), then fan-9 bisection over the 8x-compressed multiset.

    The mask stage uses ELEMENT-level counts (padding masked out of
    eq), so ties take the rank-free fast path via ``lax.cond`` exactly
    when the tie count fits the remaining slots — valid even at
    tau == 0, zero-valued ties being real elements."""
    npad = x.length_pad
    w = _wide_cols(npad)
    rows, gpr = npad // w, w // BLOCK
    codes = unpack_nibbles(x.codes)
    ca = jnp.abs(codes).astype(jnp.float32).reshape(rows, w)
    m7 = (x.scales / 7.0).reshape(rows, gpr)   # same divide as restore

    # element |values| in the wide view: ca * (s/7) is bit-identical to
    # |restore| (sign-magnitude f32: |a*b| == |a|*|b| bitwise), and the
    # a == |code| multiset candidate below is the SAME f32 product
    me = jnp.repeat(m7, BLOCK, axis=1)
    ev = ca * me
    ebits = jax.lax.bitcast_convert_type(ev, jnp.int32)

    def bisect_tau(_):
        r = jax.lax.broadcasted_iota(jnp.int32, (w, gpr), 0)
        c = jax.lax.broadcasted_iota(jnp.int32, (w, gpr), 1)
        G = jnp.where(r // BLOCK == c, 1.0, 0.0).astype(jnp.bfloat16)
        cnts, cands = [], []
        for a in range(1, 8):
            e = (ca == a).astype(jnp.bfloat16)
            cnts.append(jax.lax.dot(e, G,
                                    preferred_element_type=jnp.float32))
            cands.append(jnp.float32(a) * m7)
        counts = jnp.concatenate(cnts, axis=1)         # (rows, 7*gpr)
        cand = jnp.concatenate(cands, axis=1)
        return _tau_bisect(cand, counts, k)[0]

    tau = bisect_tau(None)

    gt = ebits > tau
    eq = ebits == tau
    if x.length < npad:
        eq = jnp.logical_and(
            eq, (jnp.arange(npad) < x.length).reshape(rows, w))
    n_above = jnp.sum(gt.astype(jnp.int32))
    n_eq = jnp.sum(eq.astype(jnp.int32))
    fastp = n_eq == k - n_above
    fill = k - n_above

    def fast(_):
        return jnp.logical_or(gt, eq)

    def slow(_):
        return _rank_tie_mask(gt, eq, fill)

    mask = jax.lax.cond(fastp, fast, slow, None)
    kept = jnp.where(mask.reshape(-1), codes, jnp.int8(0))
    return QVec4(codes=pack_nibbles(kept), scales=x.scales,
                 length=x.length)


def _threshold4_hybrid(x, k: int):
    """Large-n 4-bit threshold: per-block magnitude histogram ->
    plane-structured tau selector on the 8x-compressed multiset ->
    integer-cutoff mask.  No per-element f32 materialization; the
    bisection survives only as the verified selector's fallback.

    * selector: one ``lax.top_k`` over the nb block scales (4k-deep,
      plane-eligibility masked) + a (7B x k) pairwise weighted count
      gives a tau candidate; an EXACT verification on the compressed
      counts accepts it or falls back to the compressed bisection
      (details at the selector block below).  k > _HYBRID4_SEL_K goes
      straight to the bisection.
    * mask: |value| > tau per element, with the products c*(s_b/7)
      computed with the same expression as the wide-view ev — kept
      sets are bit-identical to _threshold4_xla.  Per block, the codes
      above tau are those above an integer cutoff, and the ties form a
      contiguous magnitude range; tie ranks come from _rank_tie_mask.

    Padding: padding elements rank after all real ties and kept zero
    codes write 0, so no padding mask is needed in the keep mask;
    n_eq itself counts real elements only.
    """
    npad = x.length_pad
    nb = npad // BLOCK
    m7 = (x.scales / 7.0).reshape(nb, 1)                # same divide as
    cs = jnp.arange(1, 8, dtype=jnp.float32)            # restore
    cand = cs[None, :] * m7                             # (nb, 7) == ev

    codes = unpack_nibbles(x.codes)                     # (npad,) int8
    a2 = jnp.abs(codes.reshape(nb, BLOCK)).astype(jnp.int8)
    h = jnp.stack([jnp.sum((a2 == c).astype(jnp.float32), axis=1)
                   for c in range(1, 8)], axis=1)
    total = jnp.sum(h)
    hflat, candflat = h.reshape(-1), cand.reshape(-1)

    def na_ne(t):
        na = jnp.sum(jnp.where(candflat > t, hflat, 0.0))
        ne = (jnp.sum(jnp.where(candflat == t, hflat, 0.0))
              + jnp.where(t == 0.0,
                          jnp.float32(x.length) - total, 0.0))
        return na, ne

    # Plane-structured selector: within magnitude plane c the candidate
    # values are c * m7 — ordered by scale — so every entry with value
    # >= tau lies among {c * s : s in the top-min(k, nb) ELIGIBLE
    # scales} (entries above tau carry weight >= 1 and total weight
    # < k, hence fewer than k per plane).  ONE top_k over the nb scales
    # (blocks with no nonzero code masked out) + pairwise weighted
    # counts over the 7*k_b candidates gives tau; the corner where a
    # plane-c-empty block displaces a real entry is caught by the exact
    # compressed verification and falls back to the bisection.  (An
    # approx_max_k-over-entries variant measured ~unusable here: its
    # ~5% misses defeat the verification on most calls and the bisect
    # fallback dominates.)
    def exact_tau(_):
        # negative sentinels bitcast below every non-negative float and
        # carry zero weight; degenerate small multisets yield bits 0 ==
        # 0.0f — the keep-everything clamp
        tb = _tau_bisect(cand, h, k)[0]
        t = jax.lax.bitcast_convert_type(tb, jnp.float32)
        na, ne = na_ne(t)
        return t, na, ne

    if k <= _HYBRID4_SEL_K:
        # gather 4k blocks: the per-plane bound says plane-c entries
        # above tau lie in the plane's top-(k-1) ELIGIBLE scales, and
        # quantized data has h[b,7] == 0 for a sizable fraction of
        # blocks (the absmax element can round to code 6 via the 1-ulp
        # divide), so a k-deep any-plane gather misses them on MOST
        # calls (measured: the bisect fallback fired every call at
        # 2^20 uniform).  4k-deep makes a miss need > 3k ineligible
        # blocks interleaved in the top 4k — vanishing; the verify +
        # fallback still guarantees exactness.
        B = min(max(4 * k, 256), nb)
        m7_eff = jnp.where(jnp.sum(h, axis=1) > 0, m7[:, 0], -1.0)
        tops, topbi = jax.lax.top_k(m7_eff, B)             # (B,)
        hsel = h[topbi]                                    # (B, 7)
        vsel = cs[None, :] * tops[:, None]                 # == cand rows
        vflat = jnp.where(hsel > 0, vsel, -1.0).reshape(-1)
        wflat = hsel.reshape(-1)
        # tau has < k multiset entries above it, so it is among the
        # top-k ENTRIES of any superset that contains it; rank only
        # those (sg over all gathered weights, (7B x k) broadcast)
        topv2, _ = jax.lax.top_k(vflat, min(k, 7 * B))
        sg = jnp.sum(jnp.where(vflat[:, None] > topv2[None, :],
                               wflat[:, None], 0.0), axis=0)
        tau_raw = jnp.min(jnp.where(sg < k, topv2, jnp.inf))
        tau_cand = jnp.where(total >= k, jnp.maximum(tau_raw, 0.0),
                             jnp.float32(0.0))
        na_c, ne_c = na_ne(tau_cand)
        ok = jnp.logical_and(na_c < k, k <= na_c + ne_c)
        tau, n_above, n_eq = jax.lax.cond(
            ok, lambda _: (tau_cand, na_c, ne_c), exact_tau, None)
    else:
        # large k: the (7k)^2 pairwise count would not pay for itself;
        # exact compressed bisection straight away
        tau, n_above, n_eq = exact_tau(None)
    fill = k - n_above

    # Per-block integer cutoffs (c*(s_b/7) is the exact element ev, and
    # it is non-decreasing in c): codes above ``cut`` are above tau, and
    # the ties are the contiguous range (below, cut] — several planes of
    # one block can round to the same f32 value (a scale so small that
    # s/7 underflows collapses all seven), so the range, not a single
    # plane, is what ties.  Zero codes tie exactly when tau == 0.
    cut = jnp.sum((cand <= tau).astype(jnp.int32), axis=1)    # (nb,) 0..7
    below = jnp.sum((cand < tau).astype(jnp.int32), axis=1)   # (nb,) 0..7
    a2i = a2.astype(jnp.int32)
    gt = (a2i > cut[:, None]).reshape(-1)
    eq = (((a2i > below[:, None]) & (a2i <= cut[:, None]))
          | ((a2i == 0) & (tau == 0.0))).reshape(-1)

    def fast(_):
        return jnp.logical_or(gt, eq)

    def slow(_):
        return _rank_tie_mask(gt, eq, fill)

    mask = jax.lax.cond(n_eq == fill, fast, slow, None)
    kept = jnp.where(mask, codes, jnp.int8(0))
    return QVec4(codes=pack_nibbles(kept), scales=x.scales,
                 length=x.length)


def _abs_restored(x) -> jax.Array:
    av = jnp.abs(restore_vec(x).values)
    npad = av.shape[-1]
    if x.length < npad:
        av = jnp.where(jnp.arange(npad) < x.length, av, -1.0)
    return av


def _dense_keep_mask(av: jax.Array, k: int) -> jax.Array:
    """Top-k keep mask over a padded |values| vector (padding = -1.0).

    Same exact-bisection structure as the 4-bit path but with the
    elements THEMSELVES as the weight-1 candidate multiset (no small
    compression exists at >= 8 bits).  Padding sentinels (-1.0) have
    negative bit patterns, below every pivot (pivots are >= 0), so they
    are never counted, never gt, and never tie.  The rank-free tie fast
    path is valid even at tau == 0 here: zero-valued ties ARE candidates
    (unlike the 4-bit multiset), so n_eq is the true tie count."""
    npad = av.shape[-1]
    w = _wide_cols(npad)
    ev = av.reshape(npad // w, w)
    ebits = jax.lax.bitcast_convert_type(ev, jnp.int32)

    def bisect_tau(_):
        return _tau_bisect(ev, jnp.ones_like(ev, jnp.int32), k)[0]

    if k <= TAU_HIER_MAX_K:
        # approx_max_k + exact verification (see _tau_approx_verified);
        # padding sentinels (-1.0) have negative bit patterns — if the
        # approx pass ever surfaces one, the verification fails into the
        # exact bisection
        tau = _tau_approx_verified(ev, k, bisect_tau)
    else:
        tau = bisect_tau(None)
    n_above = jnp.sum((ebits > tau).astype(jnp.int32))
    n_eq = jnp.sum((ebits == tau).astype(jnp.int32))
    gt = ebits > tau
    eq = ebits == tau
    fill = k - n_above

    def fast(_):
        return jnp.logical_or(gt, eq)

    def slow(_):
        return _rank_tie_mask(gt, eq, fill)

    return jax.lax.cond(n_eq == fill, fast, slow, None).reshape(-1)


def threshold(x, k: int):
    """Return x with all but its K largest-magnitude elements zeroed.

    Selection is always EXACT.  4-bit: n >= 2^19 with k <= 256 runs
    the hybrid (per-block magnitude histogram -> plane-structured top-k
    selector on the 8x-compressed multiset -> integer-cutoff mask);
    otherwise k-th-value bisection over the compressed candidate
    multiset (per-block counts of the 7 code magnitudes — the only
    values a block can take).  8/16/32-bit: for k <= 1024 an
    approx_max_k candidate PROVEN exact by one global count pass, with
    a bisection fallback the verification triggers on a miss
    (_tau_approx_verified); larger k bisect the elements directly.
    Tie-break matches the golden oracle: |value| desc, index asc."""
    k = int(k)
    if k >= x.length:
        return x

    if isinstance(x, QVec4):
        # candidate compression — value a*s_b/7 with multiplicity
        # counts[b, a], a in 1..7 (~n/9 candidates).  Large n with
        # k <= _HYBRID4_SEL_K: the hybrid (top-k on the compressed
        # multiset + integer-cutoff mask, no f32 element pass).
        if (k <= _HYBRID4_SEL_K and HYBRID4_MIN_N <= x.length_pad
                and x.length_pad < 2 ** 24):
            return _threshold4_hybrid(x, k)
        return _threshold4_xla(x, k)

    # 8/16/32-bit: the dense path (_dense_keep_mask) — approx_max_k +
    # exact verification for k <= 1024, exact dense bisection otherwise.
    mask = _dense_keep_mask(_abs_restored(x), k)
    if isinstance(x, QVec8):
        codes = jnp.where(mask, x.codes, jnp.int8(0))
        return QVec8(codes=codes, scales=x.scales, length=x.length)
    if isinstance(x, QVec16):
        return QVec16(values=jnp.where(mask, x.values, jnp.float16(0)),
                      length=x.length)
    return QVec32(values=jnp.where(mask, x.values, jnp.float32(0)),
                  length=x.length)
