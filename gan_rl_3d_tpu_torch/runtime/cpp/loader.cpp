// Host data loader of the port: point-cloud text parsing, unit-sphere
// normalisation and resampling, a copy of gan_rl_3d_tpu/runtime/cpp/
// loader.cpp with the same arithmetic (the xorshift, the seed rule, the
// copy of a cloud that already has the target size, strtof parsing), so
// a data directory gives the JAX package's arrays bit for bit.
//
// Exposed through ctypes (gan_rl_3d_tpu_torch/runtime/__init__.py), which
// builds it with g++ at first use. Functions are all `extern "C"`, operate
// on caller-allocated buffers, and touch no Python state: safe to call from
// a thread pool (ctypes drops the GIL during the call).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// Read a whole file into a malloc'd buffer (returns nullptr on failure).
char* read_file(const char* path, long* size_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) {
        std::fclose(f);
        return nullptr;
    }
    long got = static_cast<long>(std::fread(buf, 1, size, f));
    std::fclose(f);
    buf[got] = '\0';
    *size_out = got;
    return buf;
}

// Parse the first three float columns of every line of `text` into `out`
// (row-major xyz). Extra columns are skipped. Returns rows parsed.
long parse_xyz_text(char* text, float* out, long max_rows) {
    long rows = 0;
    char* p = text;
    while (*p != '\0' && rows < max_rows) {
        // parse up to 3 leading floats on this line
        int col = 0;
        while (col < 3) {
            while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
            if (*p == '\n' || *p == '\0') break;
            char* end = nullptr;
            float v = std::strtof(p, &end);
            if (end == p) break;  // non-numeric token (e.g. header word)
            out[rows * 3 + col] = v;
            p = end;
            ++col;
        }
        if (col == 3) ++rows;
        // skip to end of line
        while (*p != '\n' && *p != '\0') ++p;
        if (*p == '\n') ++p;
    }
    return rows;
}

}  // namespace

extern "C" {

// Parse an xyz text file (.txt/.pts: whitespace-separated floats, >=3
// columns per row). Writes up to max_rows rows of xyz into out.
// Returns rows parsed, or -1 if the file can't be read.
long grl_parse_xyz_file(const char* path, float* out, long max_rows) {
    long size = 0;
    char* buf = read_file(path, &size);
    if (!buf) return -1;
    long rows = parse_xyz_text(buf, out, max_rows);
    std::free(buf);
    return rows;
}

// Parse an ASCII PLY file: skips the header (through "end_header"), then
// reads the first 3 columns of each vertex line. Returns rows, or -1.
long grl_parse_ply_file(const char* path, float* out, long max_rows) {
    long size = 0;
    char* buf = read_file(path, &size);
    if (!buf) return -1;
    char* p = std::strstr(buf, "end_header");
    if (!p) {
        std::free(buf);
        return -1;
    }
    while (*p != '\n' && *p != '\0') ++p;
    if (*p == '\n') ++p;
    long rows = parse_xyz_text(p, out, max_rows);
    std::free(buf);
    return rows;
}

// In-place unit-sphere normalisation of n xyz rows (centroid to origin,
// max radius to 1) — the host-side mirror of ops.pointcloud for callers
// outside jit.
void grl_normalize_unit_sphere(float* pts, long n) {
    if (n <= 0) return;
    double cx = 0, cy = 0, cz = 0;
    for (long i = 0; i < n; ++i) {
        cx += pts[i * 3];
        cy += pts[i * 3 + 1];
        cz += pts[i * 3 + 2];
    }
    cx /= n; cy /= n; cz /= n;
    double max_r2 = 0;
    for (long i = 0; i < n; ++i) {
        double x = pts[i * 3] - cx;
        double y = pts[i * 3 + 1] - cy;
        double z = pts[i * 3 + 2] - cz;
        pts[i * 3] = static_cast<float>(x);
        pts[i * 3 + 1] = static_cast<float>(y);
        pts[i * 3 + 2] = static_cast<float>(z);
        double r2 = x * x + y * y + z * z;
        if (r2 > max_r2) max_r2 = r2;
    }
    if (max_r2 <= 0) return;
    float inv = static_cast<float>(1.0 / std::sqrt(max_r2));
    for (long i = 0; i < n * 3; ++i) pts[i] *= inv;
}

// Resample in place to exactly `target` rows using an xorshift PRNG:
// subsample without replacement (partial Fisher-Yates) when n > target,
// pad by repeating random rows when n < target. `out` must hold target
// rows; returns target.
long grl_resample(const float* pts, long n, float* out, long target,
                  uint64_t seed) {
    if (n <= 0) return -1;
    uint64_t s = seed ? seed : 0x9e3779b97f4a7c15ull;
    auto next = [&s]() {
        s ^= s << 13; s ^= s >> 7; s ^= s << 17;
        return s;
    };
    if (n == target) {
        std::memcpy(out, pts, sizeof(float) * 3 * n);
        return target;
    }
    if (n > target) {
        // partial Fisher-Yates over an index array
        long* idx = static_cast<long*>(std::malloc(sizeof(long) * n));
        if (!idx) return -1;
        for (long i = 0; i < n; ++i) idx[i] = i;
        for (long i = 0; i < target; ++i) {
            long j = i + static_cast<long>(next() % (n - i));
            long t = idx[i]; idx[i] = idx[j]; idx[j] = t;
            std::memcpy(out + i * 3, pts + idx[i] * 3, sizeof(float) * 3);
        }
        std::free(idx);
        return target;
    }
    std::memcpy(out, pts, sizeof(float) * 3 * n);
    for (long i = n; i < target; ++i) {
        long j = static_cast<long>(next() % n);
        std::memcpy(out + i * 3, pts + j * 3, sizeof(float) * 3);
    }
    return target;
}

}  // extern "C"
