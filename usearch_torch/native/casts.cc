// Native ingestion casts, the host-side loop of Index.add: a copy of the
// JAX package's usearch_tpu/native/casts.cc.
//
// Semantics mirror the reference's casting kernels
// (reference: include/usearch/index_plugins.hpp:1105-1292):
//   f32 -> i8: normalize each row to unit L2, scale to ±127, clamp,
//              truncate toward zero (cast_to_i8_gt, :1172-1191);
//   i8 -> f32: divide by 127 (cast_from_i8_gt, :1160-1170);
//   f32 -> b1: bit = value > 0, MSB-first packed (cast_to_b1x8_gt, :1139-1158).
//
// g++ -O3 vectorizes these loops; rows are split across a small thread pool.
//
// Numerics note: the max-rescale before the norm keeps f32 x*x from
// overflowing; the squared norm accumulates in double, and the build
// disables FP contraction (-ffp-contract=off), so both packages truncate at
// the same boundaries. numpy's f32 quantizer sums the norm pairwise in f32
// and divides by the maximum where this multiplies by its reciprocal: the
// two differ by one step in a few entries per ten million.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

void cast_rows_i8(const float* in, int8_t* out, int64_t rows, int64_t cols) {
    for (int64_t r = 0; r < rows; ++r) {
        const float* x = in + r * cols;
        int8_t* y = out + r * cols;
        float mx = 0.0f;
        for (int64_t c = 0; c < cols; ++c) {
            float a = std::fabs(x[c]);
            if (a > mx) mx = a;
        }
        if (mx == 0.0f) mx = 1.0f;
        float inv_mx = 1.0f / mx;
        double acc = 0.0;
        for (int64_t c = 0; c < cols; ++c) {
            float xn = x[c] * inv_mx;
            acc += (double)xn * (double)xn;
        }
        float norm = (float)std::sqrt(acc);
        if (norm == 0.0f) norm = 1.0f;
        float scale = 127.0f / norm;
        for (int64_t c = 0; c < cols; ++c) {
            float s = (x[c] * inv_mx) * scale;
            if (s > 127.0f) s = 127.0f;
            if (s < -127.0f) s = -127.0f;
            y[c] = (int8_t)s;  // C-style truncation toward zero
        }
    }
}

template <typename Fn>
void parallel_rows(int64_t rows, int threads, Fn fn) {
    if (threads <= 1 || rows < 4096) {
        fn(0, rows);
        return;
    }
    std::vector<std::thread> pool;
    int64_t per = (rows + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per > rows ? rows : lo + per;
        if (lo >= hi) break;
        pool.emplace_back([=] { fn(lo, hi); });
    }
    for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

void ut_cast_f32_to_i8(const float* in, int8_t* out, int64_t rows,
                       int64_t cols, int threads) {
    parallel_rows(rows, threads, [=](int64_t lo, int64_t hi) {
        cast_rows_i8(in + lo * cols, out + lo * cols, hi - lo, cols);
    });
}

void ut_cast_i8_to_f32(const int8_t* in, float* out, int64_t n, int threads) {
    parallel_rows(n, threads, [=](int64_t lo, int64_t hi) {
        // exact divide (not reciprocal-multiply): bit-identical to numpy's
        // values/127.0 decode, which tests compare against
        for (int64_t i = lo; i < hi; ++i) out[i] = (float)in[i] / 127.0f;
    });
}

// value > 0 -> set bit, MSB-first within each byte; rows padded with zeros
void ut_pack_bits_f32(const float* in, uint8_t* out, int64_t rows,
                      int64_t nbits, int64_t row_bytes, int threads) {
    parallel_rows(rows, threads, [=](int64_t lo, int64_t hi) {
        for (int64_t r = lo; r < hi; ++r) {
            const float* x = in + r * nbits;
            uint8_t* y = out + r * row_bytes;
            std::memset(y, 0, (size_t)row_bytes);
            for (int64_t b = 0; b < nbits; ++b)
                if (x[b] > 0.0f) y[b >> 3] |= (uint8_t)(0x80u >> (b & 7));
        }
    });
}

}  // extern "C"
