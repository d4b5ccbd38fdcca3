// Native runtime components for acmmp_spherical_tpu.
//
// The reference implements its entire host runtime in C++ (IO, orchestration,
// prior construction -- reference ACMMP.cpp / main.cpp); this library provides
// this framework's native equivalents for the host-side hot spots, exposed
// through a C ABI consumed via ctypes (no pybind11 dependency):
//
//  * .dmb raster codec (reference ACMMP.cpp:363-479)
//  * binary PLY point-cloud writer (reference ACMMP.cpp:481-534)
//  * support-point extraction for the planar prior (reference ACMMP.cpp:904-930)
//  * label rasterisation of prior triangles (reference main.cpp:144-166)
//  * bilinear grayscale resize for the loader path (reference ACMMP.cpp:605-643)
//
// All functions are thread-safe and allocation-free on the hot path (callers
// pass preallocated buffers); they are plain loops the compiler can
// auto-vectorise, compiled -O3 -march=native.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cmath>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// .dmb codec: int32 header (type=1, h, w, nb) + float payload
// ---------------------------------------------------------------------------

// Returns 0 on success. Reads header only.
int dmb_read_header(const char* path, int32_t* h, int32_t* w, int32_t* nb) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int32_t hdr[4];
    if (fread(hdr, sizeof(int32_t), 4, f) != 4 || hdr[0] != 1) {
        fclose(f);
        return -2;
    }
    *h = hdr[1];
    *w = hdr[2];
    *nb = hdr[3];
    fclose(f);
    return 0;
}

// data must hold h*w*nb floats.
int dmb_read_data(const char* path, float* data, int64_t count) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    if (fseek(f, 16, SEEK_SET) != 0) { fclose(f); return -2; }
    size_t got = fread(data, sizeof(float), (size_t)count, f);
    fclose(f);
    return got == (size_t)count ? 0 : -3;
}

int dmb_write(const char* path, const float* data, int32_t h, int32_t w,
              int32_t nb) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    int32_t hdr[4] = {1, h, w, nb};
    fwrite(hdr, sizeof(int32_t), 4, f);
    size_t n = (size_t)h * w * nb;
    size_t put = fwrite(data, sizeof(float), n, f);
    fclose(f);
    return put == n ? 0 : -2;
}

// ---------------------------------------------------------------------------
// binary PLY writer: x y z nx ny nz (f32) + r g b (u8), little endian
// ---------------------------------------------------------------------------

int ply_write(const char* path, const float* points, const float* normals,
              const uint8_t* colors, int64_t n) {
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    fprintf(f,
            "ply\nformat binary_little_endian 1.0\nelement vertex %lld\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n",
            (long long)n);
    // pack into one buffered stream of 27-byte records
    const int64_t CHUNK = 1 << 16;
    char* buf = new char[CHUNK * 27];
    for (int64_t base = 0; base < n; base += CHUNK) {
        int64_t m = std::min(CHUNK, n - base);
        char* p = buf;
        for (int64_t i = 0; i < m; ++i) {
            const float* pt = points + 3 * (base + i);
            float xyz[3] = {pt[0], pt[1], pt[2]};
            // zero non-finite coords like the reference (ACMMP.cpp:514-518)
            for (int k = 0; k < 3; ++k)
                if (!std::isfinite(xyz[k])) { xyz[0] = xyz[1] = xyz[2] = 0.f; break; }
            memcpy(p, xyz, 12); p += 12;
            memcpy(p, normals + 3 * (base + i), 12); p += 12;
            memcpy(p, colors + 3 * (base + i), 3); p += 3;
        }
        fwrite(buf, 1, (size_t)(p - buf), f);
    }
    delete[] buf;
    fclose(f);
    return 0;
}

// ---------------------------------------------------------------------------
// support points: min-cost pixel per cell if below threshold
// (reference GetSupportPoints, ACMMP.cpp:904-930)
// out_xy must hold 2 * ceil(h/cell)*ceil(w/cell) int32; returns count
// ---------------------------------------------------------------------------

int64_t support_points(const float* cost, int32_t h, int32_t w, int32_t cell,
                       float threshold, int32_t* out_xy) {
    int64_t count = 0;
    for (int32_t row = 0; row < h; row += cell) {
        int32_t rb = std::min(h, row + cell);
        for (int32_t col = 0; col < w; col += cell) {
            int32_t cb = std::min(w, col + cell);
            float best = 2.0f;
            int32_t bx = -1, by = -1;
            for (int32_t r = row; r < rb; ++r) {
                const float* src = cost + (int64_t)r * w;
                for (int32_t c = col; c < cb; ++c) {
                    float v = src[c];
                    if (v < 2.0f && v < best) { best = v; bx = c; by = r; }
                }
            }
            if (best < threshold && bx >= 0) {
                out_xy[2 * count] = bx;
                out_xy[2 * count + 1] = by;
                ++count;
            }
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// triangle label rasterisation: fills mask with (tri_index+1)
// tris: (n, 6) int32 = x0 y0 x1 y1 x2 y2; exact coverage (top-left-ish rule
// via barycentric >= 0 test, matching cv2.fillPoly's inclusive fill closely)
// ---------------------------------------------------------------------------

void rasterize_triangles(const int32_t* tris, int64_t n_tris, int32_t h,
                         int32_t w, int32_t* mask) {
    for (int64_t t = 0; t < n_tris; ++t) {
        const int32_t* v = tris + 6 * t;
        float x0 = (float)v[0], y0 = (float)v[1];
        float x1 = (float)v[2], y1 = (float)v[3];
        float x2 = (float)v[4], y2 = (float)v[5];
        int32_t minx = std::max(0, (int32_t)std::floor(std::min({x0, x1, x2})));
        int32_t maxx = std::min(w - 1, (int32_t)std::ceil(std::max({x0, x1, x2})));
        int32_t miny = std::max(0, (int32_t)std::floor(std::min({y0, y1, y2})));
        int32_t maxy = std::min(h - 1, (int32_t)std::ceil(std::max({y0, y1, y2})));
        float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
        if (area == 0.f) continue;
        float inv = 1.0f / area;
        for (int32_t y = miny; y <= maxy; ++y) {
            int32_t* row = mask + (int64_t)y * w;
            for (int32_t x = minx; x <= maxx; ++x) {
                float l0 = ((x1 - (float)x) * (y2 - (float)y) -
                            (x2 - (float)x) * (y1 - (float)y)) * inv;
                float l1 = ((x2 - (float)x) * (y0 - (float)y) -
                            (x0 - (float)x) * (y2 - (float)y)) * inv;
                float l2 = 1.0f - l0 - l1;
                if (l0 >= -1e-6f && l1 >= -1e-6f && l2 >= -1e-6f)
                    row[x] = (int32_t)(t + 1);
            }
        }
    }
}

// ---------------------------------------------------------------------------
// bilinear grayscale resize, pixel-center aligned (cv2.INTER_LINEAR semantics)
// ---------------------------------------------------------------------------

void resize_bilinear_f32(const float* src, int32_t sh, int32_t sw, float* dst,
                         int32_t dh, int32_t dw) {
    float sx = (float)sw / dw;
    float sy = (float)sh / dh;
    for (int32_t y = 0; y < dh; ++y) {
        float fy = ((float)y + 0.5f) * sy - 0.5f;
        int32_t y0 = (int32_t)std::floor(fy);
        float wy = fy - y0;
        int32_t y0c = std::clamp(y0, 0, sh - 1);
        int32_t y1c = std::clamp(y0 + 1, 0, sh - 1);
        const float* r0 = src + (int64_t)y0c * sw;
        const float* r1 = src + (int64_t)y1c * sw;
        float* out = dst + (int64_t)y * dw;
        for (int32_t x = 0; x < dw; ++x) {
            float fx = ((float)x + 0.5f) * sx - 0.5f;
            int32_t x0 = (int32_t)std::floor(fx);
            float wx = fx - x0;
            int32_t x0c = std::clamp(x0, 0, sw - 1);
            int32_t x1c = std::clamp(x0 + 1, 0, sw - 1);
            float top = r0[x0c] + (r0[x1c] - r0[x0c]) * wx;
            float bot = r1[x0c] + (r1[x1c] - r1[x0c]) * wx;
            out[x] = top + (bot - top) * wy;
        }
    }
}

}  // extern "C"
