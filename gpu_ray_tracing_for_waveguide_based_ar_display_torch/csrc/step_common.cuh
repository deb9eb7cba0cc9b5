// Device functions of one bounce, shared by the step kernels
// (split_cells.cu, vector_trace.cu): the table layouts, the Jones products,
// the TIR phasor, the region grid with its exact half-plane test (one lane
// walking the edges, or the warp an edge a lane over the grid refined where
// it is open), the in-coupler test, the record key with its strip bins, and
// the deposit bin.
// Every function is float32 with the operations of the plain PyTorch step
// (engine/trace_vector.py) in its order: build with -fmad=false so that no
// multiply-add is contracted; a division by a tensor there is __fdiv_rn
// here, and every comparison is against the float32 constant, as torch
// compares a float32 tensor with a Python scalar.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DEAD = 6;
constexpr int REC_W = 26;             // interaction record: j_a, j_b, j_c, s_a, s_b
constexpr int CELL_W = 26;            // per-cell constants
constexpr int DIR_W = 6;              // per direction: gap, TIR phasor, hop phasor
constexpr int DIR_IC = 0, DIR_FC = 1, DIR_IC2 = 2, DIR_OC = 3;
constexpr int I_JA = 0, I_JB = 8, I_SA = 16, I_SB = 17, I_COS0 = 18,
              I_ICA = 19, I_ICB = 20, C_SOUT = 21, C_EBR = 22;
// the geometry scalars (engine/trace_vector.py::GEOM_SCALARS), then the
// half-planes of the in-coupler, r1, r2 and the hull, (E, 3) each
enum { G_ICX, G_ICY, G_ICR, G_FCR0, G_FCR1, G_FC_TOP, G_FC_WIDTH, G_OCR0,
       G_OCR1, G_OC_TOP, G_OC_WIDTH, G_B0, G_B1, G_B2, G_B3, G_GRID_X0,
       G_GRID_Y0, G_GRID_INV_HX, G_GRID_INV_HY, NG };
constexpr float EDGE_TOL = 1e-6f;

// one design's geometry: its scalars, half-plane packs and region grid
struct Geom {
  const float* g;        // NG scalars
  const float* ic_hp;
  const float* r1_hp;
  const float* r2_hp;
  const float* hull_hp;
  const uint8_t* grid;   // (grid_n, grid_n) region codes
  int e_ic, e_r1, e_r2, e_hull, grid_n;
  bool circle;
};

__device__ __forceinline__ float power4(float a, float b, float c, float d) {
  return a * a + b * b + c * c + d * d;
}

// 1 / sqrt(v) with the correctly rounded root and quotient
__device__ __forceinline__ float rsqrt_rn(float v) {
  return __fdiv_rn(1.0f, __fsqrt_rn(v));
}

// split-real complex 2x2 matvec, j in row-major (re, im) order
__device__ __forceinline__ void jones(const float* j, float ter, float tei,
                                      float tmr, float tmi, float* o) {
  o[0] = j[0] * ter - j[1] * tei + j[2] * tmr - j[3] * tmi;
  o[1] = j[0] * tei + j[1] * ter + j[2] * tmi + j[3] * tmr;
  o[2] = j[4] * ter - j[5] * tei + j[6] * tmr - j[7] * tmi;
  o[3] = j[4] * tei + j[5] * ter + j[6] * tmi + j[7] * tmr;
}

__device__ __forceinline__ void phase_mul(float pr, float pi, float re,
                                          float im, float& o_re,
                                          float& o_im) {
  o_re = pr * re - pi * im;
  o_im = pr * im + pi * re;
}

// floor, clamped to [0, hi]
__device__ __forceinline__ int bin_of(float v, int hi) {
  return (int)fminf(fmaxf(floorf(v), 0.0f), (float)hi);
}

// every half-plane of hp (E, 3): x * a + y * b - c <= tol
__device__ bool hp_inside(const float* hp, int E, float x, float y) {
  for (int e = 0; e < E; ++e) {
    const float v = x * hp[3 * e] + y * hp[3 * e + 1] - hp[3 * e + 2];
    if (!(v <= EDGE_TOL)) return false;
  }
  return true;
}

__device__ __forceinline__ bool in_ic(const Geom& c, float x, float y) {
  if (c.circle) {
    const float dx = x - c.g[G_ICX];
    const float dy = y - c.g[G_ICY];
    return dx * dx + dy * dy <= c.g[G_ICR] * c.g[G_ICR];
  }
  return hp_inside(c.ic_hp, c.e_ic, x, y);
}

// (in r1, in the hull, in r2): the grid's code, and the exact test of all
// three where the grid leaves any of them open
__device__ void regions(const Geom& c, float x, float y, bool& r1,
                        bool& hull, bool& r2) {
  const float n = (float)c.grid_n;
  const float ix = floorf((x - c.g[G_GRID_X0]) * c.g[G_GRID_INV_HX]);
  const float iy = floorf((y - c.g[G_GRID_Y0]) * c.g[G_GRID_INV_HY]);
  int code = 0x2A;   // every region open
  if (ix >= 0.0f && ix < n && iy >= 0.0f && iy < n)
    code = c.grid[(int)iy * c.grid_n + (int)ix];
  const int k0 = code & 3, k1 = (code >> 2) & 3, k2 = (code >> 4) & 3;
  if (k0 == 2 || k1 == 2 || k2 == 2) {
    r1 = hp_inside(c.r1_hp, c.e_r1, x, y);
    hull = hp_inside(c.hull_hp, c.e_hull, x, y);
    r2 = hp_inside(c.r2_hp, c.e_r2, x, y);
  } else {
    r1 = k0 == 1;
    hull = k1 == 1;
    r2 = k2 == 1;
  }
}

// The region code of (x, y) from a grid refined where it is open
// (engine/trace_vector.py::region_subgrids): `fine` holds the grid's code,
// or -(t + 1) for a cell whose `sub` x `sub` subcells are row t of
// `sub_codes`; the cell is regions()'s, from the same float32 operations.
__device__ __forceinline__ int region_code_fine(const Geom& c,
                                                const int16_t* fine,
                                                const uint8_t* sub_codes,
                                                int sub, float x, float y) {
  const float n = (float)c.grid_n;
  const float fx = (x - c.g[G_GRID_X0]) * c.g[G_GRID_INV_HX];
  const float fy = (y - c.g[G_GRID_Y0]) * c.g[G_GRID_INV_HY];
  const float ix = floorf(fx), iy = floorf(fy);
  if (!(ix >= 0.0f && ix < n && iy >= 0.0f && iy < n)) return 0x2A;
  const int v = fine[(int)iy * c.grid_n + (int)ix];
  if (v >= 0) return v;
  const int su = (int)floorf((fx - ix) * (float)sub);
  const int sv = (int)floorf((fy - iy) * (float)sub);
  return sub_codes[((-1 - v) * sub + sv) * sub + su];
}

// One region of a warp's 32 positions, every lane of the warp taking part
// (the region's E half-planes hp are the same for every lane): `cls` is
// the lane's code for it (0 outside, 1 inside, 2 open).  Each lane that
// the code leaves open and whose step reads the region (`need`) has the
// exact test done by the whole warp, an edge a lane (hp_inside's float32
// operations), one such lane after another.  A code of 0 or 1 is what the
// exact test gives (engine/trace_vector.py::add_region_grids,
// region_subgrids), so wherever the step reads it the answer is
// hp_inside's bit for bit, without a lane's serial walk over its ~100
// edges while the others wait.
__device__ __forceinline__ bool region_warp(const float* hp, int E, int cls,
                                            bool need, float x, float y) {
  const int lane = threadIdx.x & 31;
  bool in = cls == 1;
  for (unsigned open = __ballot_sync(0xffffffffu, need && cls == 2); open;
       open &= open - 1) {
    const int src = __ffs(open) - 1;
    const float px = __shfl_sync(0xffffffffu, x, src);
    const float py = __shfl_sync(0xffffffffu, y, src);
    bool out = false;
    for (int e = lane; e < E; e += 32) {
      const float v = px * hp[3 * e] + py * hp[3 * e + 1] - hp[3 * e + 2];
      out = out || !(v <= EDGE_TOL);
    }
    const bool inside = !__any_sync(0xffffffffu, out);
    if (lane == src) in = inside;
  }
  return in;
}

// regions() of a warp's 32 positions where a splitting step reads them,
// every lane of the warp taking part (`active`: the lane's position
// counts): the codes from the refined grid, then region_warp's exact
// tests, the hull and r2 only where the position is in r1 (a slot outside
// r1 is dead, and the step reads neither).
__device__ void regions_warp(const Geom& c, const int16_t* fine,
                             const uint8_t* sub_codes, int sub, float x,
                             float y, bool active, bool& r1, bool& hull,
                             bool& r2) {
  const int code =
      active ? region_code_fine(c, fine, sub_codes, sub, x, y) : 0;
  r1 = region_warp(c.r1_hp, c.e_r1, code & 3, true, x, y);
  hull = region_warp(c.hull_hp, c.e_hull, (code >> 2) & 3, r1, x, y);
  r2 = region_warp(c.r2_hp, c.e_r2, (code >> 4) & 3, r1, x, y);
}

// trace_vector.site_key: the interaction record's key, site * 2 + state
// bit (site 0: IC; 1 + i: FC strip i; 1 + num_fc + i: OC strip i), and
// whether the position lies in the out-coupler's rectangle
__device__ __forceinline__ int site_key(const Geom& c, float x, float y,
                                        int state, bool grp_fc, bool grp_oc,
                                        int num_fc, int num_oc,
                                        bool& in_rect) {
  const int bit = state & 1;
  const float yrot = c.g[G_FCR0] * x + c.g[G_FCR1] * y;
  const int fc_strip = bin_of(__fdiv_rn(c.g[G_FC_TOP] - yrot,
                                        c.g[G_FC_WIDTH]), num_fc - 1);
  const float yr = c.g[G_OCR0] * x + c.g[G_OCR1] * y;
  in_rect = x >= c.g[G_B0] - EDGE_TOL && x <= c.g[G_B1] + EDGE_TOL
            && y >= c.g[G_B2] - EDGE_TOL && y <= c.g[G_B3] + EDGE_TOL;
  const int oc_strip = bin_of(__fdiv_rn(c.g[G_OC_TOP] - yr,
                                        c.g[G_OC_WIDTH]), num_oc - 1);
  const int site = grp_oc ? 1 + num_fc + oc_strip
                          : (grp_fc ? 1 + fc_strip : 0);
  return site * 2 + bit;
}

// trace_vector.deposit_bin: whether (x, y) lies in the deposit rectangle
// e = (xmin, xmax, ymin, ymax), and its bin iy * nx + ix
__device__ __forceinline__ int deposit_bin(const float* e, float x, float y,
                                           int ny, int nx, bool& in_quad) {
  in_quad = x >= e[0] - EDGE_TOL && x <= e[1] + EDGE_TOL
            && y >= e[2] - EDGE_TOL && y <= e[3] + EDGE_TOL;
  const float dxb = __fdiv_rn(e[1] - e[0], (float)nx);
  const float dyb = __fdiv_rn(e[3] - e[2], (float)ny);
  const int ix = bin_of(__fdiv_rn(x - e[0], dxb), nx - 1);
  const int iy = bin_of(__fdiv_rn(y - e[2], dyb), ny - 1);
  return iy * nx + ix;
}

}  // namespace
