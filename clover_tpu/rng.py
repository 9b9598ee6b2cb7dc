"""XORShift128+ PRNG parity module.

Re-creates the reference's stochastic-rounding noise source
(include/simdxorshift128plus.h:38-127 — Lemire's AVX XORShift128+ — and
the noise-extraction recipe of include/CloverVector4.h:690-736) so the
framework can reproduce the reference's SR noise *semantics*
bit-exactly when needed (validation parity, cross-implementation checks).

The production SR paths use JAX threefry (ops/_core.noise_like, also the
noise the MVM kernel is handed); this module exists because the
reference's PRNG is part of its observable behavior (per-thread SR streams,
fixed-seed reproducibility) and the framework must be able to match it:

* ``XorShift128Plus``: 8 independent 64-bit xorshift128+ lanes (the
  reference's two __m256i keys hold 4 lanes; containers keep TWO key pairs
  — 8 lanes total — and per-thread key arrays, CloverRandom.h:36-41).
  State lives as uint32 (hi, lo) pairs so it runs under jit without
  64-bit support; every step is a handful of lax integer ops.
* ``init`` performs the reference's 2^64 jump-chained lane seeding
  (simdxorshift128plus.h:81-92), in NumPy uint64 at construction time.
* ``jump`` advances 2^64 steps to derive independent per-shard streams —
  the analog of ``random_key1_perthread[tid]`` (CloverRandom.h:104-113).
* ``uniform_block``: the CloverVector4 noise recipe — one 256-bit draw,
  mask the top bit of every byte (0x7F mask), shift the same 32-bit lanes
  left by 0/8/16/24, convert to f32, scale by 2^-31 — yielding 32 noise
  values per draw in [0, 1) (CloverVector4.h:690-736).

A pure-NumPy uint64 implementation (`_np_next`, `np_stream`) is the golden
oracle for the JAX version.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

_JUMP = (0x8A5CD789635D2DFF, 0x121FD2155C472F96)
U64 = np.uint64


# ---------------------------------------------------------------------------
# NumPy golden (host-side, uint64)
# ---------------------------------------------------------------------------

def _np_next(s0: np.ndarray, s1: np.ndarray):
    """One xorshift128+ step on uint64 lane arrays; returns (s0', s1', out).

    Follows the reference's scalar ``xorshift128plus_onkeys`` convention
    (simdxorshift128plus.h:38-44): x = old s0 is the shifted word, c =
    old s1 becomes the new s0; out = s1' + c.
    """
    x = s0.copy()
    c = s1.copy()
    x ^= x << U64(23)
    new_s1 = x ^ c ^ (x >> U64(18)) ^ (c >> U64(5))
    return c.copy(), new_s1, new_s1 + c


def _np_jump(s0, s1):
    """Advance 2^64 steps (simdxorshift128plus.h:47-62 semantics)."""
    j0 = np.zeros_like(s0)
    j1 = np.zeros_like(s1)
    a, b = s0.copy(), s1.copy()
    for word in _JUMP:
        for bit in range(64):
            if word & (1 << bit):
                j0 ^= a
                j1 ^= b
            # scalar onkeys step: (a, b) <- (b, b^ ... ) using same update
            x = a.copy()
            x ^= x << U64(23)
            nb = x ^ b ^ (x >> U64(18)) ^ (b >> U64(5))
            a, b = b.copy(), nb
    return j0, j1


def init_lanes(key1: int, key2: int, lanes: int = 8):
    """Reference lane seeding: lane 0 = (key1, key2), lane i+1 = jump(lane i)
    (simdxorshift128plus.h:81-92, doubled to 8 lanes for the two key pairs
    of CloverRandom.h:36-38)."""
    s0 = np.zeros(lanes, U64)
    s1 = np.zeros(lanes, U64)
    s0[0], s1[0] = U64(key1 & 0xFFFFFFFFFFFFFFFF), U64(key2 & 0xFFFFFFFFFFFFFFFF)
    for i in range(1, lanes):
        a, b = _np_jump(s0[i - 1:i], s1[i - 1:i])
        s0[i], s1[i] = a[0], b[0]
    return s0, s1


def np_stream(key1: int, key2: int, n_draws: int, lanes: int = 8):
    """Golden: n_draws xorshift outputs per lane -> uint64[(n_draws, lanes)]."""
    s0, s1 = init_lanes(key1, key2, lanes)
    out = np.zeros((n_draws, lanes), U64)
    for i in range(n_draws):
        s0, s1, out[i] = _np_next(s0, s1)
    return out


# ---------------------------------------------------------------------------
# The reference's *AVX* stream (data-generation parity)
# ---------------------------------------------------------------------------

def avx_part2_lanes(key1: int, key2: int, lanes: int = 4) -> np.ndarray:
    """The four per-lane 64-bit states the vendored AVX generator actually
    evolves: ``avx_xorshift128plus_init`` fills S0/S1 by scalar jump
    chaining (simdxorshift128plus.h:81-92), but the AVX step never reads
    part1 — only the S1 (part2) lanes matter."""
    _, s1 = init_lanes(key1, key2, lanes)
    return s1.copy()


def avx_quirk_stream(state: np.ndarray, n_draws: int):
    """n_draws steps of the reference's AVX generator.

    The vendored ``avx_xorshift128plus`` (simdxorshift128plus.h:97-109)
    is NOT xorshift128+: it assigns ``part1 = part2`` and derives
    everything from part2, so each 64-bit lane evolves a 64-bit state:

        t = u ^ (u << 23);  u' = t ^ u ^ (t >> 18) ^ (u >> 5);  out = u' + u

    This quirk is observable in every random stream the reference commits
    to (data generation AND stochastic rounding), so bit-parity features
    must reproduce it.  Returns (uint32[n_draws, 2*lanes] in AVX register
    memory order — [lo32(w0), hi32(w0), lo32(w1), ...] — and the final
    lane state).
    """
    u = state.copy()
    lanes = u.shape[0]
    out = np.zeros((n_draws, 2 * lanes), np.uint32)
    for i in range(n_draws):
        t = u ^ (u << U64(23))
        un = t ^ u ^ (t >> U64(18)) ^ (u >> U64(5))
        o = un + u
        u = un
        out[i, 0::2] = (o & U64(0xFFFFFFFF)).astype(np.uint32)
        out[i, 1::2] = (o >> U64(32)).astype(np.uint32)
    return out, u


# ---------------------------------------------------------------------------
# JAX implementation (uint32 pairs; jit/scan-safe)
# ---------------------------------------------------------------------------

def _split(x64: np.ndarray):
    return (jnp.asarray((x64 >> U64(32)).astype(np.uint32)),
            jnp.asarray((x64 & U64(0xFFFFFFFF)).astype(np.uint32)))


def _shl(hi, lo, k: int):
    return ((hi << k) | (lo >> (32 - k)), lo << k)


def _shr(hi, lo, k: int):
    return (hi >> k, (lo >> k) | (hi << (32 - k)))


def _add64(ahi, alo, bhi, blo):
    lo = alo + blo
    carry = (lo < alo).astype(jnp.uint32)
    return ahi + bhi + carry, lo


class XorShift128Plus:
    """JAX xorshift128+ state: a pytree of four uint32 lane arrays."""

    def __init__(self, state):
        self.s0_hi, self.s0_lo, self.s1_hi, self.s1_lo = state

    @classmethod
    def make(cls, key1: int, key2: int, lanes: int = 8):
        s0, s1 = init_lanes(key1, key2, lanes)
        return cls((*_split(s0), *_split(s1)))

    @classmethod
    def for_shard(cls, key1: int, key2: int, shard: int, lanes: int = 8):
        """Independent per-shard stream: ``shard`` jumps of 2^64 steps each
        (the per-thread key derivation of CloverRandom.h:104-113)."""
        s0, s1 = init_lanes(key1, key2, lanes)
        for _ in range(shard):
            s0, s1 = _np_jump(s0, s1)
        return cls((*_split(s0), *_split(s1)))

    @property
    def state(self):
        return (self.s0_hi, self.s0_lo, self.s1_hi, self.s1_lo)

    def next(self):
        """One step; returns (new_state, out_hi, out_lo) — all uint32.

        Mirrors ``xorshift128plus_onkeys``: x = old s0, c = old s1."""
        ch, cl = self.s1_hi, self.s1_lo
        xh, xl = self.s0_hi, self.s0_lo
        th, tl = _shl(xh, xl, 23)
        xh, xl = xh ^ th, xl ^ tl
        ah, al = _shr(xh, xl, 18)
        bh, bl = _shr(ch, cl, 5)
        n1h = xh ^ ch ^ ah ^ bh
        n1l = xl ^ cl ^ al ^ bl
        oh, ol = _add64(n1h, n1l, ch, cl)
        new = XorShift128Plus((ch, cl, n1h, n1l))
        return new, oh, ol

    def uniform_block(self):
        """The CloverVector4.h:690-736 noise recipe, one draw.

        Returns (new_state, u) with u f32[(lanes, 8)]: per 64-bit lane
        output, both 32-bit halves are byte-masked with 0x7F and shifted
        left by 0/8/16/24, each giving a U[0,1) value via *2^-31 — i.e.
        8 noise floats per lane per draw (32 per 4-lane AVX register).
        """
        new, oh, ol = self.next()
        w = jnp.stack([ol, oh], axis=-1)                 # (lanes, 2) uint32
        m = w & jnp.uint32(0x7F7F7F7F)
        sh = [(m << k).astype(jnp.int32).astype(jnp.float32)
              for k in (0, 8, 16, 24)]
        u = jnp.stack(sh, axis=-1).reshape(*w.shape[:-1], 8)
        # negative after the int32 reinterpret never occurs: bit 31 is 0
        return new, u * jnp.float32(2.0 ** -31)


jax.tree_util.register_pytree_node(
    XorShift128Plus,
    lambda r: (r.state, None),
    lambda _, st: XorShift128Plus(st),
)
