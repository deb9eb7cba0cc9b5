// Native host-side ray seeding: pupil rejection sampling + SoA batch fill.
//
// The reference's host data path is `generate_points_in_polygon` plus a Python
// triple loop filling 12 SoA arrays for 112.5M rays
// (/root/reference/GPU_ray_tracing_functions.py:12-23,
//  gpu_ray_tracing_pro_fullColor.py:59-115).  This C++ implementation provides the
// same capability as a shared library consumed through ctypes
// (see ../gpu_ray_tracing_for_waveguide_based_ar_display_tpu/engine/native.py),
// with a splitmix64/xorshift RNG so results are reproducible independent of numpy.
//
// Build: make -C native   (produces libhostsampler.so)

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// splitmix64: seed expansion
static inline uint64_t splitmix64(uint64_t& s) {
    uint64_t z = (s += 0x9E3779B97F4A7C15ull);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return z ^ (z >> 31);
}

struct Xoshiro256 {
    uint64_t s[4];
    explicit Xoshiro256(uint64_t seed) {
        for (int i = 0; i < 4; ++i) s[i] = splitmix64(seed);
    }
    static inline uint64_t rotl(uint64_t x, int k) {
        return (x << k) | (x >> (64 - k));
    }
    inline uint64_t next() {
        uint64_t result = rotl(s[1] * 5, 7) * 9;
        uint64_t t = s[1] << 17;
        s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3];
        s[2] ^= t; s[3] = rotl(s[3], 45);
        return result;
    }
    inline double uniform() {  // [0, 1)
        return (next() >> 11) * 0x1.0p-53;
    }
};

// even-odd crossing test (same rule as the tracer oracle)
static bool point_in_polygon(double px, double py, const double* verts, int n) {
    bool inside = false;
    int j = n - 1;
    for (int i = 0; i < n; ++i) {
        double xi = verts[2 * i], yi = verts[2 * i + 1];
        double xj = verts[2 * j], yj = verts[2 * j + 1];
        if (((yi > py) != (yj > py)) &&
            (px < (xj - xi) * (py - yi) / (yj - yi + 1e-20) + xi)) {
            inside = !inside;
        }
        j = i;
    }
    return inside;
}

}  // namespace

extern "C" {

// Rejection-sample `num` points uniformly inside the polygon.
// verts: (n_verts, 2) row-major doubles.  out: (num, 2) doubles.
// Returns the number of proposal draws used (diagnostic).
long sample_points_in_polygon(const double* verts, int n_verts, long num,
                              uint64_t seed, double* out) {
    double xmin = verts[0], xmax = verts[0], ymin = verts[1], ymax = verts[1];
    for (int i = 1; i < n_verts; ++i) {
        double x = verts[2 * i], y = verts[2 * i + 1];
        if (x < xmin) xmin = x;
        if (x > xmax) xmax = x;
        if (y < ymin) ymin = y;
        if (y > ymax) ymax = y;
    }
    Xoshiro256 rng(seed);
    long got = 0, draws = 0;
    while (got < num) {
        double x = xmin + (xmax - xmin) * rng.uniform();
        double y = ymin + (ymax - ymin) * rng.uniform();
        ++draws;
        if (point_in_polygon(x, y, verts, n_verts)) {
            out[2 * got] = x;
            out[2 * got + 1] = y;
            ++got;
        }
    }
    return draws;
}

// Fill cell-major SoA ray blocks for the Pallas kernel:
//   rays_out: (n_cells, 6, rp) float32 fields (x, y, ter, tei, tmr, tmi)
//   rng_out:  (n_cells, rp) uint32
// points: (half, 2) doubles shared across cells (reference layout); first `half`
// rays of each cell are TE, the next `half` TM; slots beyond 2*half are
// zero-amplitude padding with rng state 1.
// cell_ids/rpc describe the batch; rng seeding is splitmix64(cell_id*rpc + i
// + iter_offset) matching engine/seeding.seed_fast.
void fill_ray_blocks(const double* points, long half,
                     const int* cell_ids, long n_cells, long rpc, long rp,
                     uint64_t seed, uint64_t iter_offset,
                     float* rays_out, uint32_t* rng_out) {
    const long used = 2 * half > rpc ? rpc : 2 * half;
    for (long c = 0; c < n_cells; ++c) {
        float* base = rays_out + c * 6 * rp;
        uint32_t* rng = rng_out + c * rp;
        for (long i = 0; i < rp; ++i) {
            const bool live = i < used;
            const bool is_te = i < half;
            const long pt = is_te ? i : i - half;
            const double px = live ? points[2 * pt] : 0.0;
            const double py = live ? points[2 * pt + 1] : 0.0;
            base[0 * rp + i] = static_cast<float>(px);
            base[1 * rp + i] = static_cast<float>(py);
            base[2 * rp + i] = live && is_te ? 1.0f : 0.0f;   // ter
            base[3 * rp + i] = 0.0f;                           // tei
            base[4 * rp + i] = live && !is_te ? 1.0f : 0.0f;  // tmr
            base[5 * rp + i] = 0.0f;                           // tmi
            if (live) {
                uint64_t x = static_cast<uint64_t>(cell_ids[c]) * rpc + i
                             + iter_offset
                             + seed * 0x9E3779B97F4A7C15ull;
                x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
                x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
                x = x ^ (x >> 31);
                uint32_t s = static_cast<uint32_t>(x & 0xFFFFFFFFull);
                rng[i] = s == 0 ? 1u : s;
            } else {
                rng[i] = 1u;
            }
        }
    }
}

}  // extern "C"
