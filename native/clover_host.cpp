// clover_host — native host-side runtime for clover_tpu.
//
// The reference implements its whole library in C++ (include/*.h); in the
// JAX framework the device compute path is JAX/Pallas, and this library is
// the native HOST path: a fast CPU quantizer / data loader producing the
// exact same packed containers (biased-nibble deinterleaved 4-bit layout,
// 64-element block scales — see clover_tpu/formats.py), plus the scalar
// golden semantics (quantize/restore/dot/axpy/threshold/mvm) and the
// XORShift128+ stochastic-rounding PRNG (simdxorshift128plus.h semantics,
// re-stated in clover_tpu/rng.py).  Used to stage quantized datasets for
// the device without paying the f32 host->device transfer, and as an
// independent cross-check of the Python golden oracle.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Reference semantics citations:
//   quantize: CloverVector4.h:499-514 (floor(|x|*B/s + u) * sign, clip)
//   scales:   CloverVector4.h:661-663 (block absmax, zero -> 1.0)
//   dot:      CloverVector4.h:555-595 (exact int per block, f32 combine)
//   threshold:CloverVector4.h:1929-1973 (top-K, scales untouched)
//   xorshift: simdxorshift128plus.h:38-127 (init/jump/next)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

constexpr int BLOCK = 64;
constexpr int HALF = 32;

// ---------------------------------------------------------------------
// XORShift128+ (semantics of simdxorshift128plus.h, scalar lanes)
// ---------------------------------------------------------------------

struct XsState {
    uint64_t s0, s1;
};

inline uint64_t xs_next(XsState &st) {
    uint64_t s1 = st.s0;
    const uint64_t s0 = st.s1;
    st.s0 = s0;
    s1 ^= s1 << 23;
    st.s1 = s1 ^ s0 ^ (s1 >> 18) ^ (s0 >> 5);
    return st.s1 + s0;
}

void xs_jump(XsState &st) {
    static const uint64_t JUMP[] = {0x8a5cd789635d2dffULL,
                                    0x121fd2155c472f96ULL};
    uint64_t j0 = 0, j1 = 0;
    for (uint64_t word : JUMP) {
        for (int b = 0; b < 64; b++) {
            if (word & (1ULL << b)) {
                j0 ^= st.s0;
                j1 ^= st.s1;
            }
            // onkeys step
            uint64_t x = st.s0;
            x ^= x << 23;
            uint64_t nb = x ^ st.s1 ^ (x >> 18) ^ (st.s1 >> 5);
            st.s0 = st.s1;
            st.s1 = nb;
        }
    }
    st.s0 = j0;
    st.s1 = j1;
}

// Noise recipe of CloverVector4.h:690-736: one 64-bit draw -> 8 U[0,1)
// floats (two 32-bit halves, byte-masked 0x7F, shifted 0/8/16/24, *2^-31).
inline void xs_noise8(XsState &st, float *out) {
    uint64_t w = xs_next(st);
    uint32_t halves[2] = {(uint32_t)(w & 0xFFFFFFFFu), (uint32_t)(w >> 32)};
    int idx = 0;
    for (int h = 0; h < 2; h++) {
        uint32_t m = halves[h] & 0x7F7F7F7Fu;
        for (int k = 0; k < 4; k++) {
            out[idx++] = (float)(int32_t)(m << (8 * k)) * 0x1p-31f;
        }
    }
}

// ---------------------------------------------------------------------
// Block quantization
// ---------------------------------------------------------------------

inline int8_t sr_code(float x, float mult, int qmax, float u) {
    float mag = std::fabs(x) * mult + u;
    int q = (int)std::floor(mag);
    if (q > qmax) q = qmax;
    return (int8_t)(std::signbit(x) ? -q : q);
}

inline float block_scale(const float *x, int len) {
    float s = 0.0f;
    for (int i = 0; i < len; i++) s = std::max(s, std::fabs(x[i]));
    return s == 0.0f ? 1.0f : s;
}

inline int8_t pack_byte(int lo, int hi) {
    return (int8_t)((((lo + 8) & 15) | ((hi & 15) << 4)));
}

inline void unpack_byte(int8_t p, int *lo, int *hi) {
    *lo = (p & 15) - 8;
    *hi = (int)(int8_t)p >> 4;
}

}  // namespace

extern "C" {

// ---- PRNG --------------------------------------------------------------

void clover_xs_init(uint64_t key1, uint64_t key2, int lanes,
                    uint64_t *s0_out, uint64_t *s1_out) {
    // jump-chained lane seeding (simdxorshift128plus.h:81-92)
    XsState st{key1, key2};
    for (int i = 0; i < lanes; i++) {
        s0_out[i] = st.s0;
        s1_out[i] = st.s1;
        xs_jump(st);
    }
}

void clover_xs_stream(uint64_t s0, uint64_t s1, int n, uint64_t *out) {
    XsState st{s0, s1};
    for (int i = 0; i < n; i++) out[i] = xs_next(st);
}

// ---- vector quantize / restore ------------------------------------------

// x: f32[n_pad] (n_pad % 128 == 0, padding zeroed).
// codes4: int8[n_pad/2] biased-nibble deinterleaved; scales: f32[n_pad/64].
// sr: 0 = deterministic, else XORShift-seeded stochastic rounding.
void clover_quantize_vec4(const float *x, int64_t n_pad, int8_t *codes,
                          float *scales, int sr, uint64_t seed1,
                          uint64_t seed2) {
    int64_t nb = n_pad / BLOCK;
    XsState st{seed1 ? seed1 : 1, seed2 ? seed2 : 2};
#pragma omp parallel for schedule(static) firstprivate(st)
    for (int64_t b = 0; b < nb; b++) {
        const float *xb = x + b * BLOCK;
        float s = block_scale(xb, BLOCK);
        scales[b] = s;
        float mult = 7.0f / s;
        float noise[BLOCK];
        if (sr) {
            XsState local = st;
            local.s0 += (uint64_t)b * 0x9E3779B97F4A7C15ULL + 1;
            local.s1 ^= (uint64_t)(b + 1) * 0xD1B54A32D192ED03ULL;
            for (int i = 0; i < BLOCK; i += 8) xs_noise8(local, noise + i);
        } else {
            std::memset(noise, 0, sizeof(noise));
        }
        int8_t *cb = codes + b * HALF;
        for (int j = 0; j < HALF; j++) {
            int lo = sr_code(xb[j], mult, 7, noise[j]);
            int hi = sr_code(xb[j + HALF], mult, 7, noise[j + HALF]);
            cb[j] = pack_byte(lo, hi);
        }
    }
}

void clover_quantize_vec8(const float *x, int64_t n_pad, int8_t *codes,
                          float *scales, int sr, uint64_t seed1,
                          uint64_t seed2) {
    int64_t nb = n_pad / BLOCK;
    XsState st{seed1 ? seed1 : 1, seed2 ? seed2 : 2};
#pragma omp parallel for schedule(static) firstprivate(st)
    for (int64_t b = 0; b < nb; b++) {
        const float *xb = x + b * BLOCK;
        float s = block_scale(xb, BLOCK);
        scales[b] = s;
        float mult = 127.0f / s;
        float noise[BLOCK];
        if (sr) {
            XsState local = st;
            local.s0 += (uint64_t)b * 0x9E3779B97F4A7C15ULL + 1;
            local.s1 ^= (uint64_t)(b + 1) * 0xD1B54A32D192ED03ULL;
            for (int i = 0; i < BLOCK; i += 8) xs_noise8(local, noise + i);
        } else {
            std::memset(noise, 0, sizeof(noise));
        }
        int8_t *cb = codes + b * BLOCK;
        for (int j = 0; j < BLOCK; j++)
            cb[j] = sr_code(xb[j], mult, 127, noise[j]);
    }
}

void clover_restore_vec4(const int8_t *codes, const float *scales,
                         int64_t n_pad, float *out) {
    int64_t nb = n_pad / BLOCK;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        float m = scales[b] / 7.0f;
        const int8_t *cb = codes + b * HALF;
        float *ob = out + b * BLOCK;
        for (int j = 0; j < HALF; j++) {
            int lo, hi;
            unpack_byte(cb[j], &lo, &hi);
            ob[j] = (float)lo * m;
            ob[j + HALF] = (float)hi * m;
        }
    }
}

void clover_restore_vec8(const int8_t *codes, const float *scales,
                         int64_t n_pad, float *out) {
    int64_t nb = n_pad / BLOCK;
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nb; b++) {
        float m = scales[b] / 127.0f;
        for (int j = 0; j < BLOCK; j++)
            out[b * BLOCK + j] = (float)codes[b * BLOCK + j] * m;
    }
}

// ---- dot (exact int accumulation per block, ordered f32 combine) ---------

float clover_dot4(const int8_t *uc, const float *us, const int8_t *vc,
                  const float *vs, int64_t n_pad) {
    int64_t nb = n_pad / BLOCK;
    float acc = 0.0f;
    for (int64_t b = 0; b < nb; b++) {
        int32_t s = 0;
        for (int j = 0; j < HALF; j++) {
            int ulo, uhi, vlo, vhi;
            unpack_byte(uc[b * HALF + j], &ulo, &uhi);
            unpack_byte(vc[b * HALF + j], &vlo, &vhi);
            s += ulo * vlo + uhi * vhi;
        }
        acc += (us[b] / 7.0f) * (vs[b] / 7.0f) * (float)s;
    }
    return acc;
}

float clover_dot8(const int8_t *uc, const float *us, const int8_t *vc,
                  const float *vs, int64_t n_pad) {
    int64_t nb = n_pad / BLOCK;
    float acc = 0.0f;
    for (int64_t b = 0; b < nb; b++) {
        int32_t s = 0;
        for (int j = 0; j < BLOCK; j++)
            s += (int)uc[b * BLOCK + j] * (int)vc[b * BLOCK + j];
        acc += (us[b] / 127.0f) * (vs[b] / 127.0f) * (float)s;
    }
    return acc;
}

// ---- matrix quantize (row-major, 64x64 tile scales) ----------------------

void clover_quantize_mat4(const float *a, int64_t m_pad, int64_t n_pad,
                          int8_t *codes, float *scales, int sr,
                          uint64_t seed1, uint64_t seed2) {
    int64_t mb = m_pad / BLOCK, nb = n_pad / BLOCK;
    // tile absmax pass
#pragma omp parallel for schedule(static)
    for (int64_t bi = 0; bi < mb; bi++) {
        for (int64_t bj = 0; bj < nb; bj++) {
            float s = 0.0f;
            for (int r = 0; r < BLOCK; r++) {
                const float *row = a + (bi * BLOCK + r) * n_pad + bj * BLOCK;
                for (int c = 0; c < BLOCK; c++)
                    s = std::max(s, std::fabs(row[c]));
            }
            scales[bi * nb + bj] = s == 0.0f ? 1.0f : s;
        }
    }
    XsState st{seed1 ? seed1 : 1, seed2 ? seed2 : 2};
#pragma omp parallel for schedule(static) firstprivate(st)
    for (int64_t r = 0; r < m_pad; r++) {
        int64_t bi = r / BLOCK;
        float noise[BLOCK];
        XsState local = st;
        local.s0 += (uint64_t)r * 0x9E3779B97F4A7C15ULL + 1;
        local.s1 ^= (uint64_t)(r + 1) * 0xD1B54A32D192ED03ULL;
        for (int64_t bj = 0; bj < nb; bj++) {
            float mult = 7.0f / scales[bi * nb + bj];
            const float *xb = a + r * n_pad + bj * BLOCK;
            if (sr) {
                for (int i = 0; i < BLOCK; i += 8) xs_noise8(local, noise + i);
            } else {
                std::memset(noise, 0, sizeof(noise));
            }
            int8_t *cb = codes + r * (n_pad / 2) + bj * HALF;
            for (int j = 0; j < HALF; j++) {
                int lo = sr_code(xb[j], mult, 7, noise[j]);
                int hi = sr_code(xb[j + HALF], mult, 7, noise[j + HALF]);
                cb[j] = pack_byte(lo, hi);
            }
        }
    }
}

// ---- fused MVM (pure 4-bit, band requantized output) ----------------------

void clover_mvm4(const int8_t *ac, const float *as, const int8_t *xc,
                 const float *xs, int64_t m_pad, int64_t n_pad,
                 int8_t *yc, float *ys) {
    int64_t nb = n_pad / BLOCK, mb = m_pad / BLOCK;
    std::vector<float> y(m_pad);
#pragma omp parallel for schedule(static)
    for (int64_t r = 0; r < m_pad; r++) {
        int64_t bi = r / BLOCK;
        float acc = 0.0f;
        for (int64_t b = 0; b < nb; b++) {
            int32_t s = 0;
            const int8_t *arow = ac + r * (n_pad / 2) + b * HALF;
            const int8_t *xrow = xc + b * HALF;
            for (int j = 0; j < HALF; j++) {
                int alo, ahi, xlo, xhi;
                unpack_byte(arow[j], &alo, &ahi);
                unpack_byte(xrow[j], &xlo, &xhi);
                s += alo * xlo + ahi * xhi;
            }
            acc += (as[bi * nb + b] / 7.0f) * (xs[b] / 7.0f) * (float)s;
        }
        y[r] = acc;
    }
    // band requantization (deterministic)
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < mb; b++) {
        float s = block_scale(y.data() + b * BLOCK, BLOCK);
        ys[b] = s;
        float mult = 7.0f / s;
        for (int j = 0; j < HALF; j++) {
            int lo = sr_code(y[b * BLOCK + j], mult, 7, 0.0f);
            int hi = sr_code(y[b * BLOCK + j + HALF], mult, 7, 0.0f);
            yc[b * HALF + j] = pack_byte(lo, hi);
        }
    }
}

// ---- threshold (top-K by |value|, lower index wins ties; scales kept) ----

void clover_threshold4(int8_t *codes, const float *scales, int64_t n_pad,
                       int64_t length, int64_t k) {
    std::vector<float> vals(length);
    for (int64_t i = 0; i < length; i++) {
        int64_t b = i / BLOCK, j = i % BLOCK;
        int lo, hi;
        unpack_byte(codes[b * HALF + (j % HALF)], &lo, &hi);
        int code = (j < HALF) ? lo : hi;
        vals[i] = std::fabs((float)code * (scales[b] / 7.0f));
    }
    std::vector<int64_t> idx(length);
    for (int64_t i = 0; i < length; i++) idx[i] = i;
    std::stable_sort(idx.begin(), idx.end(), [&](int64_t a, int64_t b) {
        return vals[a] > vals[b];
    });
    std::vector<uint8_t> keep(length, 0);
    for (int64_t i = 0; i < std::min(k, length); i++) keep[idx[i]] = 1;
    for (int64_t i = 0; i < length; i++) {
        if (keep[i]) continue;
        int64_t b = i / BLOCK, j = i % BLOCK;
        int8_t *p = &codes[b * HALF + (j % HALF)];
        int lo, hi;
        unpack_byte(*p, &lo, &hi);
        if (j < HALF) lo = 0; else hi = 0;
        *p = pack_byte(lo, hi);
    }
}

int clover_host_version(void) { return 1; }

}  // extern "C"
