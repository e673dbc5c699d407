// rt_native — host-side native runtime for rt_tpu.
//
// Provides the C++ pieces that mirror the reference's native layers:
//   * RGBA8888 packing + PNG encoding (image.cpp / back_buffer.cpp analogues;
//     PNG writer added because the reference has no image export at all —
//     SURVEY.md §5 checkpoint/resume gap).
//   * A multithreaded CPU path tracer implementing the same documented
//     semantics as the reference renderer (mg personality: lambert+metal,
//     linear SoA scans, no BVH — /root/reference/src/renderers/
//     mg_ray_tracer.cpp behaviourally, written fresh around flat arrays and
//     an iterative bounce loop).  This is the *measured* CPU baseline for
//     bench.py: the reference itself cannot be built here (its meson wraps
//     need network access), so the baseline is established with this
//     equivalent, compiled -O3 -march=native -ffast-math like the
//     reference's release flags (meson.build:141-160).
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

// ---------------------------------------------------------------------------
// RGBA packing (colour.hpp:100-106 semantics: clamp, *255.99999, truncate)
// ---------------------------------------------------------------------------

extern "C" void rtn_pack_rgba8888(const float* rgba, uint32_t* out, long long n_pixels) {
    for (long long i = 0; i < n_pixels; ++i) {
        uint32_t w = 0;
        for (int c = 0; c < 4; ++c) {
            float v = rgba[i * 4 + c];
            v = v < 0.f ? 0.f : (v > 1.f ? 1.f : v);
            w = (w << 8) | (uint32_t)(v * 255.99999f);
        }
        out[i] = w;
    }
}

// ---------------------------------------------------------------------------
// PNG writer (RGBA8, stored-deflate blocks; no external deps)
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t n = 0; n < 256; ++n) {
        uint32_t c = n;
        for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[n] = c;
    }
    crc_init_done = true;
}

static uint32_t crc32_update(uint32_t crc, const uint8_t* buf, size_t len) {
    if (!crc_init_done) crc_init();
    uint32_t c = crc;
    for (size_t i = 0; i < len; ++i) c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c;
}

static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
    v.push_back((x >> 24) & 0xFF);
    v.push_back((x >> 16) & 0xFF);
    v.push_back((x >> 8) & 0xFF);
    v.push_back(x & 0xFF);
}

static void png_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t len) {
    put_be32(out, (uint32_t)len);
    size_t start = out.size();
    out.insert(out.end(), tag, tag + 4);
    out.insert(out.end(), data, data + len);
    uint32_t crc = crc32_update(0xFFFFFFFFu, out.data() + start, len + 4) ^ 0xFFFFFFFFu;
    put_be32(out, crc);
}

extern "C" int rtn_write_png(const char* path, const uint8_t* rgba, int w, int h) {
    // raw scanlines with filter byte 0
    std::vector<uint8_t> raw;
    raw.reserve((size_t)h * (1 + (size_t)w * 4));
    for (int y = 0; y < h; ++y) {
        raw.push_back(0);
        raw.insert(raw.end(), rgba + (size_t)y * w * 4, rgba + (size_t)(y + 1) * w * 4);
    }

    // zlib stream with stored (uncompressed) deflate blocks
    std::vector<uint8_t> z;
    z.push_back(0x78);
    z.push_back(0x01);
    size_t pos = 0;
    uint32_t a = 1, b = 0;
    while (pos < raw.size()) {
        size_t blk = raw.size() - pos;
        if (blk > 65535) blk = 65535;
        bool last = (pos + blk == raw.size());
        z.push_back(last ? 1 : 0);
        z.push_back(blk & 0xFF);
        z.push_back((blk >> 8) & 0xFF);
        z.push_back(~blk & 0xFF);
        z.push_back((~blk >> 8) & 0xFF);
        z.insert(z.end(), raw.begin() + pos, raw.begin() + pos + blk);
        for (size_t i = 0; i < blk; ++i) {
            a = (a + raw[pos + i]) % 65521;
            b = (b + a) % 65521;
        }
        pos += blk;
    }
    put_be32(z, (b << 16) | a);

    std::vector<uint8_t> out;
    const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    out.insert(out.end(), sig, sig + 8);
    uint8_t ihdr[13];
    ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
    ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
    ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
    ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
    ihdr[8] = 8; ihdr[9] = 6; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
    png_chunk(out, "IHDR", ihdr, 13);
    png_chunk(out, "IDAT", z.data(), z.size());
    png_chunk(out, "IEND", nullptr, 0);

    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    size_t n = fwrite(out.data(), 1, out.size(), f);
    fclose(f);
    return n == out.size() ? 0 : 2;
}

// ---------------------------------------------------------------------------
// CPU baseline path tracer (mg personality)
// ---------------------------------------------------------------------------

struct V3 {
    float x, y, z;
};
static inline V3 v3(float x, float y, float z) { return {x, y, z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 norm3(V3 a) {
    float n = std::sqrt(dot(a, a));
    return n > 0.f ? a * (1.f / n) : a;
}

struct SceneArrays {
    const float* sph_c;   // (S,3)
    const float* sph_r;   // (S,)
    const int32_t* sph_m; // (S,)
    int n_spheres;
    const float* pl_n;    // (P,3)
    const float* pl_d;    // (P,)
    const int32_t* pl_m;  // (P,)
    int n_planes;
    const int32_t* mat_type;   // (M,)
    const float* mat_albedo;   // (M,4)
    const float* mat_rough;    // (M,)
    const float* mat_refl;     // (M,)
};

// xoshiro-style PRNG (fast; the baseline should not be RNG-bound)
struct Rng {
    uint64_t s;
    inline uint32_t next() {
        s ^= s << 13;
        s ^= s >> 7;
        s ^= s << 17;
        return (uint32_t)(s >> 32);
    }
    inline float uf() { return (next() >> 8) * (1.0f / 16777216.0f); }  // U[0,1)
    inline V3 unit() {
        // reference distribution: normalize(U[0,1)^3) (random.hpp:57-66)
        for (;;) {
            V3 p = v3(uf(), uf(), uf());
            float n2 = dot(p, p);
            if (n2 > 0.f) return p * (1.f / std::sqrt(n2));
        }
    }
};

static const float MIN_HIT = 0.001f;

struct Hit {
    float t;
    V3 n;
    int mat;
};

static inline bool closest_hit(const SceneArrays& sc, V3 o, V3 d, Hit& h) {
    float best_t = 3.0e38f;
    int best_i = -1;
    bool is_sphere = false;
    for (int i = 0; i < sc.n_planes; ++i) {
        V3 n = v3(sc.pl_n[i * 3], sc.pl_n[i * 3 + 1], sc.pl_n[i * 3 + 2]);
        float nd = dot(n, d);
        if (std::fabs(nd) < 1e-12f) continue;
        float t = -(dot(n, o) + sc.pl_d[i]) / nd;
        if (t < MIN_HIT || t >= best_t) continue;
        best_t = t;
        best_i = i;
        is_sphere = false;
    }
    for (int i = 0; i < sc.n_spheres; ++i) {
        V3 c = v3(sc.sph_c[i * 3], sc.sph_c[i * 3 + 1], sc.sph_c[i * 3 + 2]);
        V3 oc = o - c;
        float b = dot(oc, d);
        float c0 = dot(oc, oc) - sc.sph_r[i] * sc.sph_r[i];
        float disc = b * b - c0;
        if (disc < 0.f) continue;
        float sq = std::sqrt(disc);
        float t = -b - sq;
        if (t < MIN_HIT) t = -b + sq;
        if (t < MIN_HIT || t > best_t) continue;  // spheres win ties (select())
        best_t = t;
        best_i = i;
        is_sphere = true;
    }
    if (best_i < 0) return false;
    h.t = best_t;
    if (is_sphere) {
        V3 c = v3(sc.sph_c[best_i * 3], sc.sph_c[best_i * 3 + 1], sc.sph_c[best_i * 3 + 2]);
        h.n = norm3((o + d * best_t) - c);
        h.mat = sc.sph_m[best_i];
    } else {
        h.n = v3(sc.pl_n[best_i * 3], sc.pl_n[best_i * 3 + 1], sc.pl_n[best_i * 3 + 2]);
        h.mat = sc.pl_m[best_i];
    }
    return true;
}

// personality 0 = mg (metal + lambert-for-everything-else,
// mg_ray_tracer.cpp:142-152); personality 1 = sm (adds the dielectric
// family: dielectric/air/vacuum/water/ice -> dielectric_scatter, diamond
// stays lambert, sm_ray_tracer.cpp:221-236).  The dielectric math mirrors
// the JAX renderer's documented estimator (sm_ray_tracer.cpp:181-219
// semantics with normalized scatter directions) so device-vs-CPU ratios
// compare matched estimators.
static V3 trace(const SceneArrays& sc, V3 o, V3 d, int max_bounces, Rng& rng,
                int personality) {
    V3 thr = v3(1, 1, 1);
    for (int b = 0; b < max_bounces; ++b) {
        Hit h;
        if (!closest_hit(sc, o, d, h)) {
            float t = 0.5f * (d.y + 1.0f);
            V3 sky = v3(1, 1, 1) * (1.f - t) + v3(0.5f, 0.7f, 1.0f) * t;
            return thr * sky;
        }
        float refl = sc.mat_refl[h.mat];
        V3 alb = v3(sc.mat_albedo[h.mat * 4], sc.mat_albedo[h.mat * 4 + 1],
                    sc.mat_albedo[h.mat * 4 + 2]);
        V3 att = alb * refl;
        V3 nd;
        int ty = sc.mat_type[h.mat];
        bool die = personality == 1 && (ty >= 2 && ty <= 6);
        if (die) {  // dielectric family (sm_ray_tracer.cpp:181-219)
            float dd = dot(d, h.n);
            bool inside = dd > 0.f;
            V3 on = inside ? h.n * -1.f : h.n;
            float ior = refl;  // reflectivity field carries the IOR
            float eta = inside ? ior : 1.f / ior;
            float cosine = inside ? ior * dd : -dd;
            float cos_i = -dot(d, on);
            float sin2 = eta * eta * (1.f - cos_i * cos_i);
            V3 r = d - h.n * (2.f * dd);  // geometric-normal reflect
            float prob;
            if (sin2 > 1.f) {
                prob = 1.f;  // total internal reflection
            } else {
                float r0 = (1.f - ior) / (1.f + ior);
                r0 *= r0;
                float omc = 1.f - cosine;
                prob = r0 + (1.f - r0) * omc * omc * omc * omc * omc;
            }
            if (rng.uf() < prob) {
                nd = norm3(r);
            } else {
                float cos_t = std::sqrt(sin2 < 1.f ? 1.f - sin2 : 0.f);
                nd = norm3(d * eta + on * (eta * cos_i - cos_t));
            }
        } else if (ty == 1) {  // metal
            V3 r = d - h.n * (2.f * dot(d, h.n));
            nd = r + rng.unit() * sc.mat_rough[h.mat];
            if (dot(nd, h.n) <= 0.f) return v3(0, 0, 0);  // absorbed
            nd = norm3(nd);
        } else {  // lambert (everything else defaults to lambert)
            nd = h.n + rng.unit();
            float n2 = dot(nd, nd);
            nd = n2 < 1e-16f ? h.n : nd * (1.f / std::sqrt(n2));
        }
        o = o + d * h.t;
        d = nd;
        thr = thr * att;
    }
    return v3(0, 0, 0);
}

// Render W x H @ spp with the camera given as position + rotation columns.
// out: (H*W*3) floats (post sqrt-gamma).  Returns seconds elapsed.
// personality: 0 = mg, 1 = sm (dielectrics).
extern "C" double rtn_render(const float* cam_pos, const float* cam_rot,  // (3,), (3,3) row-major
                     float vfov, float near_clip,
                     int w, int h, int spp, int max_bounces, uint64_t seed,
                     const float* sph_c, const float* sph_r, const int32_t* sph_m, int n_spheres,
                     const float* pl_n, const float* pl_d, const int32_t* pl_m, int n_planes,
                     const int32_t* mat_type, const float* mat_albedo,
                     const float* mat_rough, const float* mat_refl,
                     int personality,
                     float* out) {
    SceneArrays sc{sph_c, sph_r, sph_m, n_spheres, pl_n, pl_d, pl_m, n_planes,
                   mat_type, mat_albedo, mat_rough, mat_refl};
    V3 pos = v3(cam_pos[0], cam_pos[1], cam_pos[2]);
    // rotation: row-major 3x3, columns are (right, up, backward)
    float th = std::tan(vfov * 0.5f);
    float aspect = (float)w / (float)h;

    auto t0 = std::chrono::steady_clock::now();
    unsigned n_threads = std::thread::hardware_concurrency();
    if (n_threads == 0) n_threads = 4;
    std::atomic<int> next_row{0};
    std::vector<std::thread> pool;
    for (unsigned ti = 0; ti < n_threads; ++ti) {
        pool.emplace_back([&, ti]() {
            Rng rng{seed * 0x9E3779B97F4A7C15ull + ti * 0xBF58476D1CE4E5B9ull + 1ull};
            for (;;) {
                int y = next_row.fetch_add(1);
                if (y >= h) break;
                for (int x = 0; x < w; ++x) {
                    V3 acc = v3(0, 0, 0);
                    for (int s = 0; s < spp; ++s) {
                        float jx = s == 0 ? 0.5f : rng.uf();
                        float jy = s == 0 ? 0.5f : rng.uf();
                        float nx = 2.f * ((x + jx) / w) - 1.f;
                        float ny = 1.f - 2.f * ((y + jy) / h);
                        V3 dv = v3(nx * th * aspect, ny * th, -1.f);
                        V3 dw = v3(cam_rot[0] * dv.x + cam_rot[1] * dv.y + cam_rot[2] * dv.z,
                                   cam_rot[3] * dv.x + cam_rot[4] * dv.y + cam_rot[5] * dv.z,
                                   cam_rot[6] * dv.x + cam_rot[7] * dv.y + cam_rot[8] * dv.z);
                        V3 o = pos + dw * near_clip;
                        V3 d = norm3(dw);
                        acc = acc + trace(sc, o, d, max_bounces, rng, personality);
                    }
                    acc = acc * (1.f / spp);
                    size_t idx = ((size_t)y * w + x) * 3;
                    out[idx] = std::sqrt(acc.x);
                    out[idx + 1] = std::sqrt(acc.y);
                    out[idx + 2] = std::sqrt(acc.z);
                }
            }
        });
    }
    for (auto& t : pool) t.join();
    auto t1 = std::chrono::steady_clock::now();
    return std::chrono::duration<double>(t1 - t0).count();
}

// Backwards-compatible mg-only entry point.
extern "C" double rtn_render_mg(const float* cam_pos, const float* cam_rot,
                     float vfov, float near_clip,
                     int w, int h, int spp, int max_bounces, uint64_t seed,
                     const float* sph_c, const float* sph_r, const int32_t* sph_m, int n_spheres,
                     const float* pl_n, const float* pl_d, const int32_t* pl_m, int n_planes,
                     const int32_t* mat_type, const float* mat_albedo,
                     const float* mat_rough, const float* mat_refl,
                     float* out) {
    return rtn_render(cam_pos, cam_rot, vfov, near_clip, w, h, spp,
                      max_bounces, seed, sph_c, sph_r, sph_m, n_spheres,
                      pl_n, pl_d, pl_m, n_planes, mat_type, mat_albedo,
                      mat_rough, mat_refl, 0, out);
}

