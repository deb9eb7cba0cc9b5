// The vector Monte-Carlo engine for NVIDIA Hopper (sm_90a): one launch
// traces a (D, R) ray batch to the end of its bounce budget.
//
// Replaces no Pallas kernel.  The JAX package runs this engine
// (engine/trace_jnp.py::make_trace_fn_dynamic, its engine="jnp") as jnp
// under a jax.lax.while_loop on its device; the port's plain PyTorch
// version (engine/trace_vector.py::vector_trace_reference) runs that loop
// eagerly from the host: about 300 operations and two reads of the device
// a bounce.  Here one thread carries one ray through every bounce, so a
// trace call is one launch and no bounce reads the device from the host.
//
// A ray's outcome depends only on its own fields, its design's tables and
// geometry, and its own RNG stream, and a dead ray is a fixed point of the
// bounce, so each thread runs its ray alone: the in-coupling (full mode),
// then bounces until the ray dies or has run the budget, then the deposit
// bin of an out-coupled ray from its final position.  The arithmetic is
// the plain version's float32 operations in its order (no contraction:
// -fmad=false; 1 / sqrt as __fdiv_rn(1, __fsqrt_rn(v)); a division by a
// tensor as __fdiv_rn; every comparison against a float32 constant), and
// the RNG advances only where the ray interacts (ops/rng.draw_uniform).
// Every output goes to new buffers: the inputs are never written.  Per
// design the rays' counts of steps begun alive are summed with integer
// atomics (exact in any order), and the largest count is the trace's
// steps.
//
// What bounds it on an H100: the ray state's bytes, 68 B read (nine
// float32 fields, state, rng, dep, cid, idx) and 52 B written a ray; its
// float32 work is 42 to about 140 operations a bounce.  Design: one thread
// per ray, 256 threads a block; the tables, geometry rows and grids are
// read through the L1 and L2 caches; a warp runs until its longest ray
// ends, while the lanes of rays that ended idle.  Lanes that refill from
// their block's range of rays (csrc/cell_trace.cu's design) would change
// no output; on a batch of simulate --engine vector they measured no
// faster than this simple kernel, so it stays simple.

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr int OUT = -2;                 // dep: out-coupled, bin not yet taken
constexpr uint32_t RESEED = 0x6D2B79F5u;
enum { F_X, F_Y, F_TER, F_TEI, F_TMR, F_TMI, F_COS, F_GX, F_GY, NFLOAT };
// the ray buffers: NFLOAT float32 fields, then state, rng, dep (in and
// out), then cid and idx (in only)
constexpr int NIN = NFLOAT + 5;
constexpr int NOUT = NFLOAT + 3;

struct Args {
  const float* rec;      // (26, ncell * R2) component-major
  const float* cell;     // (26, ncell)
  const float* dirs;     // (6, ncell * 4)
  const float* geom;     // (D, NG + 3 * edges) geometry rows
  const uint8_t* grid;   // (D, grid_n, grid_n) region codes
  const float* f_in[NFLOAT];
  const int* st_in;
  const long long* rng_in;
  const int* dep_in;
  const long long* cid;
  const long long* idx;
  float* f_out[NFLOAT];
  int* st_out;
  long long* rng_out;
  int* dep_out;
  unsigned long long* bounces;  // (D,)
  int* steps;                   // ()
  long long n;                  // D * R
  int D, R, C, ncell, R2, num_fc, num_oc, ny, nx, max_bounces, full;
  int circle, grid_n, e_ic, e_r1, e_r2, e_hull;
};

struct Ray {
  float x, y, ter, tei, tmr, tmi, cos, gx, gy;
  int st, dep;
  long long rng;
};

// the per-ray views of the component-major tables
struct Tables {
  const float* cell;     // component k at cell[k * ncell]
  const float* dirs;     // direction q, component k at dirs[k * 4 * ncell + q]
  const float* rec;      // key k, component j at rec[j * ncell * R2 + k]
  long long s_cell, s_dirs, s_rec;
};

// ops/rng.draw_uniform for one ray: the draw, and the advanced state
__device__ __forceinline__ float draw(long long state, long long idx,
                                      long long& advanced) {
  uint32_t s = state == 0 ? RESEED ^ (uint32_t)(idx + 1) : (uint32_t)state;
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  advanced = (long long)s;
  return (float)(s >> 8) * (1.0f / 16777216.0f);
}

// torch.clamp(v, min=1e-30): a NaN stays NaN
__device__ __forceinline__ float clamp_pw(float v) {
  return v < 1e-30f ? 1e-30f : v;
}

// the first in-coupler interaction from air (trace_vector._init_step)
__device__ void init_step(const Tables& t, const Geom& geo, long long idx,
                          Ray& r) {
  float ja[8], jb[8];
  for (int k = 0; k < 8; ++k) {
    ja[k] = t.cell[(I_JA + k) * t.s_cell];
    jb[k] = t.cell[(I_JB + k) * t.s_cell];
  }
  float pa[4], pb[4];
  jones(ja, r.ter, r.tei, r.tmr, r.tmi, pa);
  jones(jb, r.ter, r.tei, r.tmr, r.tmi, pb);
  const float cos0 = t.cell[I_COS0 * t.s_cell];
  const float eff_a = __fdiv_rn(power4(pa[0], pa[1], pa[2], pa[3])
                                * t.cell[I_SA * t.s_cell], cos0);
  const float eff_b = __fdiv_rn(power4(pb[0], pb[1], pb[2], pb[3])
                                * t.cell[I_SB * t.s_cell], cos0);
  long long rng;
  const float u = draw(r.rng, idx, rng);
  const bool a = u <= eff_a;
  const bool b = !a && u <= eff_a + eff_b;
  const float* p = a ? pa : pb;
  const float inv = rsqrt_rn(clamp_pw(power4(p[0], p[1], p[2], p[3])));
  const int dir = a ? DIR_IC : DIR_IC2;
  const float d0 = t.dirs[0 * t.s_dirs + dir], d1 = t.dirs[1 * t.s_dirs + dir];
  const float d2 = t.dirs[2 * t.s_dirs + dir], d3 = t.dirs[3 * t.s_dirs + dir];
  const float x = r.x + d0;
  const float y = r.y + d1;
  const bool ic_in = in_ic(geo, x, y);
  const int st = a ? (ic_in ? 0 : 2) : (b ? (ic_in ? 1 : DEAD) : DEAD);
  if (st < DEAD) {
    r.x = x;
    r.y = y;
    r.ter = p[0] * inv;
    r.tei = p[1] * inv;
    phase_mul(d2, d3, p[2] * inv, p[3] * inv, r.tmr, r.tmi);
    r.cos = t.cell[(a ? I_ICA : I_ICB) * t.s_cell];
    r.gx = d0;
    r.gy = d1;
  } else {
    r.gx = 0.0f;
    r.gy = 0.0f;
  }
  r.st = st;
  r.rng = rng;
}

// one bounce of a live ray (trace_vector._bounce_step)
__device__ void bounce(const Tables& t, const Geom& geo, int num_fc,
                       int num_oc, long long idx, Ray& r) {
  const float x = r.x, y = r.y;
  const int state = r.st;
  bool in_r1, in_hull, in_r2;
  regions(geo, x, y, in_r1, in_hull, in_r2);
  if (!in_r1) {           // global containment: the ray keeps its fields
    r.st = DEAD;
    return;
  }
  const bool grp_ic = state <= 1;
  const bool grp_fc = state == 2 || state == 3;
  const bool grp_oc = state >= 4;
  bool in_rect;
  const int key = site_key(geo, x, y, state, grp_fc, grp_oc, num_fc, num_oc,
                           in_rect);
  const bool hit_fc = grp_fc && in_hull;
  const bool hit_oc = grp_oc && in_rect;
  if (grp_ic || hit_fc || hit_oc) {
    float jr[24];
    for (int k = 0; k < 24; ++k) jr[k] = t.rec[k * t.s_rec + key];
    const float s_a = t.rec[24 * t.s_rec + key];
    const float s_b = t.rec[25 * t.s_rec + key];
    float pa[4], pb[4];
    jones(jr, r.ter, r.tei, r.tmr, r.tmi, pa);
    jones(jr + 8, r.ter, r.tei, r.tmr, r.tmi, pb);
    const float inv_cos = __fdiv_rn(1.0f, r.cos);
    const float eff_a = power4(pa[0], pa[1], pa[2], pa[3]) * s_a * inv_cos;
    const float eff_b = power4(pb[0], pb[1], pb[2], pb[3]) * s_b * inv_cos;
    long long rng;
    const float u = draw(r.rng, idx, rng);
    r.rng = rng;
    const bool br_a = u <= eff_a && eff_a > 0.0f;
    const bool br_b = !br_a && u <= eff_a + eff_b && eff_b > 0.0f;
    if (br_a || br_b) {
      const int dir = br_a ? (grp_oc ? DIR_FC : DIR_IC)
                           : (grp_ic ? DIR_IC2 : (grp_fc ? DIR_FC : DIR_OC));
      const float* p = br_a ? pa : pb;
      const float inv = rsqrt_rn(clamp_pw(power4(p[0], p[1], p[2], p[3])));
      const float d0 = t.dirs[0 * t.s_dirs + dir];
      const float d1 = t.dirs[1 * t.s_dirs + dir];
      const float d2 = t.dirs[2 * t.s_dirs + dir];
      const float d3 = t.dirs[3 * t.s_dirs + dir];
      r.ter = p[0] * inv;
      r.tei = p[1] * inv;
      phase_mul(d2, d3, p[2] * inv, p[3] * inv, r.tmr, r.tmi);
      r.cos = br_a ? s_a : s_b;
      r.gx = d0;
      r.gy = d1;
      r.x = x + d0;
      r.y = y + d1;
      int st_a = grp_oc ? 4 : (grp_fc ? 2 : -1);
      int st_b = grp_oc ? 5 : (grp_fc ? 3 : -1);
      if (grp_ic) {
        const bool ic_in = in_ic(geo, r.x, r.y);
        st_a = ic_in ? 0 : 2;
        st_b = ic_in ? 1 : DEAD;
      }
      r.st = br_a ? st_a : st_b;
      return;
    }
    bool br_c = false;
    if (hit_oc) {
      float pc[4];
      jones(jr + 16, r.ter, r.tei, r.tmr, r.tmi, pc);
      const float eff_c = power4(pc[0], pc[1], pc[2], pc[3])
                          * t.cell[C_SOUT * t.s_cell] * inv_cos;
      br_c = u <= eff_a + eff_b + eff_c && eff_c > 0.0f;
    }
    if (br_c) r.dep = OUT;   // the bin is taken from this position at the end
    r.st = DEAD;             // out-coupled, or killed by the roulette
    return;
  }
  // a miss: a TIR hop with the doubled phasor, or a phase transition
  const bool miss_fc2 = grp_fc && state == 2;
  const bool miss_fc3 = grp_fc && state == 3;
  const bool hop = miss_fc2 || (miss_fc3 && in_r2) || (grp_oc && state == 4);
  if (hop) {
    const int hop_dir = miss_fc2 ? DIR_IC : DIR_FC;
    const float h4 = t.dirs[4 * t.s_dirs + hop_dir];
    const float h5 = t.dirs[5 * t.s_dirs + hop_dir];
    float tmr, tmi;
    phase_mul(h4, h5, r.tmr, r.tmi, tmr, tmi);
    r.x = x + r.gx;
    r.y = y + r.gy;
    r.tmr = tmr;
    r.tmi = tmi;
  } else if (miss_fc3) {
    r.st = 4;                // FC3 leaves r2: on to the out-coupler
  } else if (grp_oc && state == 5) {
    r.st = DEAD;
  }
}

// ray i's fields, its design d, its geometry row and its table views
__device__ __forceinline__ void load_ray(const Args& a, long long i, Ray& r,
                                         int& d, long long& idx, Geom& geo,
                                         Tables& t) {
  d = (int)(i / a.R);
  const int width = NG + 3 * (a.e_ic + a.e_r1 + a.e_r2 + a.e_hull);
  geo.g = a.geom + (size_t)d * width;
  geo.ic_hp = geo.g + NG;
  geo.r1_hp = geo.ic_hp + 3 * a.e_ic;
  geo.r2_hp = geo.r1_hp + 3 * a.e_r1;
  geo.hull_hp = geo.r2_hp + 3 * a.e_r2;
  geo.grid = a.grid + (size_t)d * a.grid_n * a.grid_n;
  geo.e_ic = a.e_ic;
  geo.e_r1 = a.e_r1;
  geo.e_r2 = a.e_r2;
  geo.e_hull = a.e_hull;
  geo.grid_n = a.grid_n;
  geo.circle = a.circle != 0;
  idx = a.idx[i];
  const long long g = a.cid[i] + (long long)a.C * d;
  t.s_cell = a.ncell;
  t.s_dirs = 4LL * a.ncell;
  t.s_rec = (long long)a.ncell * a.R2;
  t.cell = a.cell + g;
  t.dirs = a.dirs + 4 * g;
  t.rec = a.rec + g * a.R2;
  r.x = a.f_in[F_X][i];
  r.y = a.f_in[F_Y][i];
  r.ter = a.f_in[F_TER][i];
  r.tei = a.f_in[F_TEI][i];
  r.tmr = a.f_in[F_TMR][i];
  r.tmi = a.f_in[F_TMI][i];
  r.cos = a.f_in[F_COS][i];
  r.gx = a.f_in[F_GX][i];
  r.gy = a.f_in[F_GY][i];
  r.st = a.st_in[i];
  r.rng = a.rng_in[i];
  r.dep = a.dep_in[i];
}

// an ended ray: the deposit bin of an out-coupled ray from its final
// position, then every output field at the ray's own index
__device__ __forceinline__ void finish_ray(const Args& a, long long i,
                                           const Tables& t, Ray& r) {
  if (r.dep == OUT) {
    float e[4];
    for (int k = 0; k < 4; ++k) e[k] = t.cell[(C_EBR + k) * t.s_cell];
    bool in_quad;
    const int b = deposit_bin(e, r.x, r.y, a.ny, a.nx, in_quad);
    r.dep = in_quad ? b : -1;
  }
  a.f_out[F_X][i] = r.x;
  a.f_out[F_Y][i] = r.y;
  a.f_out[F_TER][i] = r.ter;
  a.f_out[F_TEI][i] = r.tei;
  a.f_out[F_TMR][i] = r.tmr;
  a.f_out[F_TMI][i] = r.tmi;
  a.f_out[F_COS][i] = r.cos;
  a.f_out[F_GX][i] = r.gx;
  a.f_out[F_GY][i] = r.gy;
  a.st_out[i] = r.st;
  a.rng_out[i] = r.rng;
  a.dep_out[i] = r.dep;
}

// a warp's bounces into their design's total (one atomic a warp unless its
// lanes hold two designs) and its longest ray into the steps; every lane
// of the warp calls it
__device__ __forceinline__ void add_counts(const Args& a, int d,
                                           unsigned long long n, int most) {
  const int lane = threadIdx.x & 31;
  const int d0 = __shfl_sync(FULL, d, 0);
  if (__all_sync(FULL, d == d0)) {
    unsigned long long sum = n;
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    if (lane == 0 && sum) atomicAdd(a.bounces + d0, sum);
  } else if (n) {
    atomicAdd(a.bounces + d, n);
  }
  const int m = (int)__reduce_max_sync(FULL, (unsigned)most);
  if (lane == 0 && m) atomicMax(a.steps, m);
}

// one thread per ray
__global__ void __launch_bounds__(THREADS)
vector_trace_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  int d = a.D - 1, n = 0;
  if (i < a.n) {
    Ray r;
    long long idx;
    Geom geo;
    Tables t;
    load_ray(a, i, r, d, idx, geo, t);
    if (a.full) init_step(t, geo, idx, r);
    while (n < a.max_bounces && r.st < DEAD) {
      ++n;
      bounce(t, geo, a.num_fc, a.num_oc, idx, r);
    }
    finish_ray(a, i, t, r);
  }
  add_counts(a, d, (unsigned long long)n, n);
}

}  // namespace

// Launch on `stream`: the vector trace of D * R rays (layouts as in Args;
// ray_in holds NIN pointers, ray_out NOUT, in the order of Args).  bounces
// and steps must be zero.  Returns a cudaError_t code (0: launched).
extern "C" int vector_trace_launch(
    const void* rec, const void* cell, const void* dirs, const void* geom,
    const void* grid, const void* const* ray_in, void* const* ray_out,
    void* bounces, void* steps, int D, int R, int C, int R2, int num_fc,
    int num_oc, int ny, int nx, int max_bounces, int full, int circle,
    int grid_n, int e_ic, int e_r1, int e_r2, int e_hull, void* stream) {
  if (D < 1 || R < 0 || C < 1 || R2 != 2 * (1 + num_fc + num_oc) ||
      num_fc < 1 || num_oc < 1 || ny < 1 || nx < 1 || grid_n < 1 ||
      e_ic < 0 || e_r1 < 0 || e_r2 < 0 || e_hull < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)D * R;
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.rec = static_cast<const float*>(rec);
  a.cell = static_cast<const float*>(cell);
  a.dirs = static_cast<const float*>(dirs);
  a.geom = static_cast<const float*>(geom);
  a.grid = static_cast<const uint8_t*>(grid);
  for (int k = 0; k < NFLOAT; ++k) {
    a.f_in[k] = static_cast<const float*>(ray_in[k]);
    a.f_out[k] = static_cast<float*>(ray_out[k]);
  }
  a.st_in = static_cast<const int*>(ray_in[NFLOAT]);
  a.rng_in = static_cast<const long long*>(ray_in[NFLOAT + 1]);
  a.dep_in = static_cast<const int*>(ray_in[NFLOAT + 2]);
  a.cid = static_cast<const long long*>(ray_in[NFLOAT + 3]);
  a.idx = static_cast<const long long*>(ray_in[NFLOAT + 4]);
  a.st_out = static_cast<int*>(ray_out[NFLOAT]);
  a.rng_out = static_cast<long long*>(ray_out[NFLOAT + 1]);
  a.dep_out = static_cast<int*>(ray_out[NFLOAT + 2]);
  a.bounces = static_cast<unsigned long long*>(bounces);
  a.steps = static_cast<int*>(steps);
  a.n = n;
  a.D = D;
  a.R = R;
  a.C = C;
  a.ncell = D * C;
  a.R2 = R2;
  a.num_fc = num_fc;
  a.num_oc = num_oc;
  a.ny = ny;
  a.nx = nx;
  a.max_bounces = max_bounces;
  a.full = full;
  a.circle = circle;
  a.grid_n = grid_n;
  a.e_ic = e_ic;
  a.e_r1 = e_r1;
  a.e_r2 = e_r2;
  a.e_hull = e_hull;
  vector_trace_kernel<<<(unsigned)blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* vector_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
