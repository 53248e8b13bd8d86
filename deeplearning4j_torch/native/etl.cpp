// Native host-ETL kernels of deeplearning4j_torch: the port's own copy of
// the JAX package's native/etl.cpp, the same source built with the same
// flags, so both packages' native arms give the same bytes.
//
// The reference keeps its hot host-side paths native (libnd4j behind JNI,
// the DataVec readers). Here the device math belongs to PyTorch and the
// hand-written CUDA kernels, and the host ETL (the feed side of the
// prefetch pipeline) is this file: pixel scaling, standardization, CSV float
// parsing, row gathers, one-hot labels and the bilinear image resize.
//
// Build: deeplearning4j_torch/native_etl.py compiles it at first use with
//   g++ -O3 -mtune=native -Wall -fPIC -shared -std=c++17 -fopenmp
// into build/torch_kernels/. Every entry point is plain C, bound by ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// uint8 pixels -> float32 in [min_range, max_range] (the
// ImagePreProcessingScaler hot loop; dst may be the training batch
// buffer directly). OpenMP over chunks: this is a pure streaming loop,
// so threads split the bandwidth.
void u8_to_f32_scaled(const uint8_t* src, float* dst, int64_t n,
                      float max_pixel, float min_range, float max_range) {
    const float span = (max_range - min_range) / max_pixel;
#pragma omp parallel for schedule(static) if (n > 1 << 16)
    for (int64_t i = 0; i < n; ++i) {
        dst[i] = static_cast<float>(src[i]) * span + min_range;
    }
}

// float32 standardize in place: (x - mean[c]) / std[c] over trailing
// feature axis of size c_len (NormalizerStandardize.transform hot loop).
void f32_standardize(float* data, int64_t rows, int64_t c_len,
                     const float* mean, const float* stddev) {
#pragma omp parallel for schedule(static) if (rows * c_len > 1 << 16)
    for (int64_t r = 0; r < rows; ++r) {
        float* row = data + r * c_len;
        for (int64_t c = 0; c < c_len; ++c) {
            row[c] = (row[c] - mean[c]) / stddev[c];
        }
    }
}

// Parse a delimiter-separated buffer of ASCII floats. Returns the number
// parsed (<= max_out). Newlines count as delimiters; empty fields skip.
// (CSVRecordReader's inner loop without Python string objects.)
int64_t parse_csv_floats(const char* buf, int64_t len, char delimiter,
                         float* out, int64_t max_out) {
    int64_t count = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end && count < max_out) {
        // skip delimiters/newlines/spaces
        while (p < end && (*p == delimiter || *p == '\n' || *p == '\r' ||
                           *p == ' ')) {
            ++p;
        }
        if (p >= end) break;
        char* next = nullptr;
        float v = strtof(p, &next);
        if (next == p) {  // unparseable token: skip to next delimiter
            while (p < end && *p != delimiter && *p != '\n') ++p;
            continue;
        }
        out[count++] = v;
        p = next;
    }
    return count;
}

// Gather rows: out[i] = table[idx[i]] for embedding-style host-side
// assembly (word2vec negative-table sampling batches).
void gather_rows_f32(const float* table, const int32_t* idx, float* out,
                     int64_t n_rows, int64_t dim) {
    for (int64_t i = 0; i < n_rows; ++i) {
        std::memcpy(out + i * dim, table + static_cast<int64_t>(idx[i]) * dim,
                    dim * sizeof(float));
    }
}

// One-hot encode int labels into a zeroed float32 buffer [n, classes].
void one_hot_f32(const int32_t* labels, float* out, int64_t n,
                 int64_t classes) {
    std::memset(out, 0, sizeof(float) * n * classes);
    for (int64_t i = 0; i < n; ++i) {
        int64_t c = labels[i];
        if (c >= 0 && c < classes) {
            out[i * classes + c] = 1.0f;
        }
    }
}

// Bilinear resize of an HWC uint8 image (ImageRecordReader's
// scale-to-network-input step; half-pixel-center sampling like OpenCV's
// INTER_LINEAR, which is what DataVec's NativeImageLoader uses).
void u8_resize_bilinear_hwc(const uint8_t* src, int64_t h, int64_t w,
                            int64_t c, uint8_t* dst, int64_t oh,
                            int64_t ow) {
    const float sy = static_cast<float>(h) / static_cast<float>(oh);
    const float sx = static_cast<float>(w) / static_cast<float>(ow);
    // precompute the column sample positions/weights once per image
    std::vector<int64_t> x0s(ow), x1s(ow);
    std::vector<float> wxs(ow);
    for (int64_t x = 0; x < ow; ++x) {
        float fx = (static_cast<float>(x) + 0.5f) * sx - 0.5f;
        if (fx < 0) fx = 0;
        int64_t x0 = static_cast<int64_t>(fx);
        if (x0 > w - 1) x0 = w - 1;
        x0s[x] = x0;
        x1s[x] = x0 + 1 < w ? x0 + 1 : w - 1;
        wxs[x] = fx - static_cast<float>(x0);
    }
#pragma omp parallel for schedule(static) if (oh * ow * c > 1 << 15)
    for (int64_t y = 0; y < oh; ++y) {
        float fy = (static_cast<float>(y) + 0.5f) * sy - 0.5f;
        if (fy < 0) fy = 0;
        int64_t y0 = static_cast<int64_t>(fy);
        if (y0 > h - 1) y0 = h - 1;
        int64_t y1 = y0 + 1 < h ? y0 + 1 : h - 1;
        const float wy = fy - static_cast<float>(y0);
        const uint8_t* row0 = src + y0 * w * c;
        const uint8_t* row1 = src + y1 * w * c;
        uint8_t* drow = dst + y * ow * c;
        for (int64_t x = 0; x < ow; ++x) {
            const float wx = wxs[x];
            const uint8_t* p00 = row0 + x0s[x] * c;
            const uint8_t* p01 = row0 + x1s[x] * c;
            const uint8_t* p10 = row1 + x0s[x] * c;
            const uint8_t* p11 = row1 + x1s[x] * c;
            uint8_t* d = drow + x * c;
            for (int64_t ch = 0; ch < c; ++ch) {
                const float top = p00[ch] + (p01[ch] - p00[ch]) * wx;
                const float bot = p10[ch] + (p11[ch] - p10[ch]) * wx;
                const float v = top + (bot - top) * wy;
                d[ch] = static_cast<uint8_t>(v + 0.5f);
            }
        }
    }
}

// Cap this thread's OpenMP team size. Worker threads that already
// parallelize at the image level (ImageRecordReaderDataSetIterator's
// pool) call this with 1 so the per-row pragmas don't nest a second
// parallelism layer and oversubscribe the host.
void etl_set_omp_threads(int n) {
#ifdef _OPENMP
    omp_set_num_threads(n > 0 ? n : 1);
#else
    (void)n;
#endif
}

int etl_abi_version() { return 2; }

}  // extern "C"
