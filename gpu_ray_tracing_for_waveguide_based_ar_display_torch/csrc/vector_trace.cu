// The vector Monte-Carlo engine for NVIDIA Hopper (sm_90a): one launch
// traces a (D, R) ray batch to the end of its bounce budget.
//
// Replaces no Pallas kernel.  The JAX package runs this engine
// (engine/trace_jnp.py::make_trace_fn_dynamic, its engine="jnp") as jnp
// under a jax.lax.while_loop on its device; the port's plain PyTorch
// version (engine/trace_vector.py::vector_trace_reference) runs that loop
// eagerly from the host: about 300 operations and two reads of the device
// a bounce.  Here a lane carries a ray through every bounce, so a trace
// call is one launch and no bounce reads the device from the host.
//
// A ray's outcome depends only on its own fields, its design's tables and
// geometry, and its own RNG stream, and a dead ray is a fixed point of the
// bounce, so each lane runs its ray alone: the in-coupling (full mode),
// then bounces until the ray dies or has run the budget, then the deposit
// bin of an out-coupled ray from its final position.  The arithmetic is
// the plain version's float32 operations in its order (no contraction:
// -fmad=false; 1 / sqrt as __fdiv_rn(1, __fsqrt_rn(v)); a division by a
// tensor as __fdiv_rn; every comparison against a float32 constant), and
// the RNG advances only where the ray interacts (ops/rng.draw_uniform).
// Every output goes to new buffers: the inputs are never written.  Per
// design the rays' counts of steps begun alive are summed with integer
// atomics (exact in any order), and the largest count is the trace's
// steps, so the outputs do not depend on which lane runs which ray.
//
// What bounds it on an H100: the ray state's bytes, 68 B read (nine
// float32 fields, state, rng, dep, cid, idx) and 52 B written a ray; its
// float32 work is 42 to about 140 operations a bounce.  Design: a block of
// 256 threads owns a range of 256 to 2,048 rays of one design (the launch
// sizes it to about ten waves of resident blocks: rays_per_thread), so a
// warp's geometry and grids are one design's.  Its warps loop while any
// lane holds a live ray, a bounce a round, every lane taking part: the
// region codes come from the design's grid refined where it is open
// (trace_vector.region_subgrids_stacked), and the positions they leave open
// are tested by the whole warp, an edge a lane (region_warp): r1 for every
// live ray, the hull only for FC-group rays in r1, r2 only where an FC3
// miss reads it.  A lane whose ray ended writes it out and, once REFILL
// lanes of its warp are free (or all are), the free lanes claim the next
// rays of the block's range together (one shared atomicAdd a warp), so
// lanes do not idle while the warp's longest ray runs on.  The tables and
// geometry rows are read through the L1 and L2 caches; a lane keeps only
// its ray, its (design, cell) index and its counts across bounces (64
// registers, no spills, four blocks an SM).  On an NVIDIA H100 80GB HBM3
// at 700 W a 2,048-cell batch of simulate --engine vector (10.24 M rays,
// 88.0 M bounces) takes about 3.8 ms against a 0.37 ms byte bound, most
// of it in the interactions' dependent arithmetic and loads; the exact
// region tests take about a tenth (PERF.md; tools/vector_trace_phases.py
// splits it by phase).

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

// Phase marks, empty here: tools/vector_trace_phases.py builds a copy that
// defines them, timing each warp's phases with clock64 (each mark ends the
// phase named in this list, at a point the warp reaches converged; "count"
// is the counters' own time) and counting bounces, open positions, exact
// tests and interactions.
// VT_MARK phases: claim init lookup count exact key interact hop finish
#ifndef VT_MARK
#define VT_BEGIN()
#define VT_MARK(k)
#define VT_COUNT(k, v)
#define VT_END()
#endif

namespace {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 4;
constexpr int MAX_RAYS_PER_THREAD = 8;  // a block's range at most, a thread
constexpr int WAVES = 10;               // waves of resident blocks a launch
constexpr int REFILL = 8;               // free lanes at which a warp claims
constexpr unsigned FULL = 0xffffffffu;
constexpr int OUT = -2;                 // dep: out-coupled, bin not yet taken
constexpr uint32_t RESEED = 0x6D2B79F5u;
enum { F_X, F_Y, F_TER, F_TEI, F_TMR, F_TMI, F_COS, F_GX, F_GY, NFLOAT };
// the ray buffers: NFLOAT float32 fields, then state, rng, dep (in and
// out), then cid and idx (in only)
constexpr int NIN = NFLOAT + 5;
constexpr int NOUT = NFLOAT + 3;
// the marks' phases (mark k ends phase k) and counters
enum { P_CLAIM = 1, P_INIT, P_LOOKUP, P_COUNT, P_EXACT, P_KEY, P_INTERACT,
       P_HOP, P_FINISH };
enum { C_WARP_STEPS, C_BOUNCES, C_OPEN, C_OPEN_WARPS, C_FINE_OPEN,
       C_FINE_OPEN_WARPS, C_TESTS, C_EDGES, C_INTERACTIONS, C_RAYS };

struct Args {
  const float* rec;      // (26, ncell * R2) component-major
  const float* cell;     // (26, ncell)
  const float* dirs;     // (6, ncell * 4)
  const float* geom;     // (D, NG + 3 * edges) geometry rows
  const int16_t* fine;   // (D, grid_n, grid_n) refined region codes
  const uint8_t* sub_codes;   // (M, sub, sub) subcell region codes
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
  int D, R, C, ncell, R2, num_fc, num_oc, ny, nx, max_bounces, full;
  int circle, grid_n, sub, e_ic, e_r1, e_r2, e_hull;
  int range, blocks_per_design;   // rays of a block's range, its blocks
};

struct Ray {
  float x, y, ter, tei, tmr, tmi, cos, gx, gy;
  int st, dep;
  long long rng;
};

// the views of the component-major tables at one (design, cell) pair
struct Tables {
  const float* cell;     // component k at cell[k * ncell]
  const float* dirs;     // direction q, component k at dirs[k * 4 * ncell + q]
  const float* rec;      // key k, component j at rec[j * ncell * R2 + k]
  long long s_cell, s_dirs, s_rec;
};

// built where they are read from the launch's arguments and the pair's
// index g, so that a lane carries only g from one bounce to the next
__device__ __forceinline__ Tables tables_at(const Args& a, long long g) {
  Tables t;
  t.s_cell = a.ncell;
  t.s_dirs = 4LL * a.ncell;
  t.s_rec = (long long)a.ncell * a.R2;
  t.cell = a.cell + g;
  t.dirs = a.dirs + 4 * g;
  t.rec = a.rec + g * a.R2;
  return t;
}

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

// an interaction of a live ray in r1 at its record `key`
// (trace_vector._bounce_step's accepted branches, C and the roulette)
__device__ void interact(const Tables& t, const Geom& geo, int key,
                         bool hit_oc, long long idx, Ray& r) {
  const int state = r.st;
  const bool grp_ic = state <= 1;
  const bool grp_fc = state == 2 || state == 3;
  const bool grp_oc = state >= 4;
  const float x = r.x, y = r.y;
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
}

// a miss of a live ray in r1: a TIR hop with the doubled phasor, or a
// phase transition
__device__ __forceinline__ void miss(const Tables& t, bool in_r2, Ray& r) {
  const int state = r.st;
  const bool hop = state == 2 || (state == 3 && in_r2) || state == 4;
  if (hop) {
    const int hop_dir = state == 2 ? DIR_IC : DIR_FC;
    const float h4 = t.dirs[4 * t.s_dirs + hop_dir];
    const float h5 = t.dirs[5 * t.s_dirs + hop_dir];
    float tmr, tmi;
    phase_mul(h4, h5, r.tmr, r.tmi, tmr, tmi);
    r.x = r.x + r.gx;
    r.y = r.y + r.gy;
    r.tmr = tmr;
    r.tmi = tmi;
  } else if (state == 3) {
    r.st = 4;                // FC3 leaves r2: on to the out-coupler
  } else if (state == 5) {
    r.st = DEAD;
  }
}

// design d's geometry row (its region codes come from the refined grid),
// built where it is read, as the tables are
__device__ __forceinline__ Geom geom_at(const Args& a, int d) {
  Geom geo;
  const int width = NG + 3 * (a.e_ic + a.e_r1 + a.e_r2 + a.e_hull);
  geo.g = a.geom + (size_t)d * width;
  geo.ic_hp = geo.g + NG;
  geo.r1_hp = geo.ic_hp + 3 * a.e_ic;
  geo.r2_hp = geo.r1_hp + 3 * a.e_r1;
  geo.hull_hp = geo.r2_hp + 3 * a.e_r2;
  geo.grid = nullptr;   // the region codes come from `fine`
  geo.e_ic = a.e_ic;
  geo.e_r1 = a.e_r1;
  geo.e_r2 = a.e_r2;
  geo.e_hull = a.e_hull;
  geo.grid_n = a.grid_n;
  geo.circle = a.circle != 0;
  return geo;
}

// ray i of design d: its fields, and its (design, cell) pair g
__device__ __forceinline__ void load_ray(const Args& a, long long i, int d,
                                         Ray& r, long long& idx,
                                         long long& g) {
  idx = a.idx[i];
  g = a.cid[i] + (long long)a.C * d;
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

#ifdef VT_ON
// the marked copy's counters: whether the coarse grid (a refined cell's
// row, or a cell past the rows) and the refined grid leave (x, y) open
__device__ __forceinline__ bool coarse_open(const Geom& c,
                                            const int16_t* fine, float x,
                                            float y) {
  const float n = (float)c.grid_n;
  const float ix = floorf((x - c.g[G_GRID_X0]) * c.g[G_GRID_INV_HX]);
  const float iy = floorf((y - c.g[G_GRID_Y0]) * c.g[G_GRID_INV_HY]);
  if (!(ix >= 0.0f && ix < n && iy >= 0.0f && iy < n)) return true;
  const int v = fine[(int)iy * c.grid_n + (int)ix];
  return v < 0 || ((v >> 1) & ~v & 0x15) != 0;
}
__device__ __forceinline__ bool code_open(int code) {
  return ((code >> 1) & ~code & 0x15) != 0;
}
#endif

// Each warp loops while any lane holds a live ray; see the file's head.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
vector_trace_kernel(const Args a) {
  __shared__ int s_next;     // the next unclaimed ray of the block's range
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const int d = blockIdx.x / a.blocks_per_design;
  const int first = (blockIdx.x - d * a.blocks_per_design) * a.range;
  const int len = min(a.range, a.R - first);
  const long long base_i = (long long)d * a.R + first;
  const int16_t* fine = a.fine + (size_t)d * a.grid_n * a.grid_n;
  if (threadIdx.x == 0) s_next = 0;
  __syncthreads();
  VT_BEGIN();
  Ray r;
  r.st = DEAD;
  r.x = r.y = 0.0f;
  long long i = -1, idx = 0, g = 0;
  int nb = 0, most = 0;
  unsigned long long sum = 0;
  bool alive = false, more = true;
  for (;;) {
    if (i >= 0 && !alive) {      // the lane's ray ended
      finish_ray(a, i, tables_at(a, g), r);
      sum += nb;
      most = max(most, nb);
      i = -1;
    }
    VT_MARK(P_FINISH);
    const unsigned want = __ballot_sync(FULL, i < 0 && more);
    const bool any_alive = __any_sync(FULL, alive);
    if (!want && !any_alive) break;
    if (want && (!any_alive || __popc(want) >= REFILL)) {
      const int leader = __ffs(want) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(&s_next, __popc(want));
      base = __shfl_sync(FULL, base, leader);
      if ((want >> lane) & 1) {
        const int k = base + __popc(want & below);
        if (k < len) {
          i = base_i + k;
          load_ray(a, i, d, r, idx, g);
          nb = 0;
          VT_COUNT(C_RAYS, 1);
        } else {
          more = false;
        }
      }
      VT_MARK(P_CLAIM);
      const bool fresh = ((want >> lane) & 1) && i >= 0;
      if (fresh && a.full)
        init_step(tables_at(a, g), geom_at(a, d), idx, r);
      if (fresh) alive = nb < a.max_bounces && r.st < DEAD;
      VT_MARK(P_INIT);
      if (!__any_sync(FULL, alive)) continue;
    }
    // one bounce of every live ray of the warp
    const Geom geo = geom_at(a, d);
    const float x = r.x, y = r.y;
    const int state = r.st;
    const int code =
        alive ? region_code_fine(geo, fine, a.sub_codes, a.sub, x, y) : 0;
    VT_MARK(P_LOOKUP);
    VT_COUNT(C_WARP_STEPS, lane == 0);
    VT_COUNT(C_BOUNCES, alive);
    VT_COUNT(C_OPEN, alive && coarse_open(geo, fine, x, y));
    VT_COUNT(C_OPEN_WARPS,
             __any_sync(FULL, alive && coarse_open(geo, fine, x, y))
             && lane == 0);
    VT_COUNT(C_FINE_OPEN, alive && code_open(code));
    VT_COUNT(C_FINE_OPEN_WARPS,
             __any_sync(FULL, alive && code_open(code)) && lane == 0);
    VT_MARK(P_COUNT);
    const bool grp_fc = state == 2 || state == 3;
    const bool in_r1 = region_warp(geo.r1_hp, a.e_r1, code & 3, alive, x, y);
    const bool in_hull = region_warp(geo.hull_hp, a.e_hull, (code >> 2) & 3,
                                     in_r1 && grp_fc, x, y);
    const bool in_r2 = region_warp(geo.r2_hp, a.e_r2, (code >> 4) & 3,
                                   in_r1 && state == 3 && !in_hull, x, y);
    VT_MARK(P_EXACT);
    VT_COUNT(C_TESTS, (alive && (code & 3) == 2)
                      + (in_r1 && grp_fc && ((code >> 2) & 3) == 2)
                      + (in_r1 && state == 3 && !in_hull
                         && ((code >> 4) & 3) == 2));
    VT_COUNT(C_EDGES, (alive && (code & 3) == 2) * a.e_r1
                      + (in_r1 && grp_fc && ((code >> 2) & 3) == 2)
                        * a.e_hull
                      + (in_r1 && state == 3 && !in_hull
                         && ((code >> 4) & 3) == 2) * a.e_r2);
    VT_MARK(P_COUNT);
    // outside r1 the ray dies where it is (global containment)
    const bool grp_oc = state >= 4;
    int key = 0;
    bool hit = false, hit_oc = false;
    if (alive) {
      ++nb;
      if (!in_r1) {
        r.st = DEAD;
      } else {
        bool in_rect;
        key = site_key(geo, x, y, state, grp_fc, grp_oc, a.num_fc, a.num_oc,
                       in_rect);
        hit_oc = grp_oc && in_rect;
        hit = state <= 1 || (grp_fc && in_hull) || hit_oc;
      }
    }
    VT_MARK(P_KEY);
    VT_COUNT(C_INTERACTIONS, hit);
    VT_MARK(P_COUNT);
    if (hit) interact(tables_at(a, g), geo, key, hit_oc, idx, r);
    VT_MARK(P_INTERACT);
    if (alive && in_r1 && !hit) miss(tables_at(a, g), in_r2, r);
    VT_MARK(P_HOP);
    alive = alive && nb < a.max_bounces && r.st < DEAD;
  }
  VT_END();
  // the warp's bounces into its design's total and its longest ray into
  // the steps
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  const int m = (int)__reduce_max_sync(FULL, (unsigned)most);
  if (lane == 0 && sum) atomicAdd(a.bounces + d, sum);
  if (lane == 0 && m) atomicMax(a.steps, m);
}

// Rays a thread of a block's range: enough for about WAVES waves of the
// card's resident blocks over the launch's n rays, 1 to MAX_RAYS_PER_THREAD.
// A wider range lets a warp's lanes refill for longer before its last rays
// drain; more blocks keep the last wave short.
cudaError_t rays_per_thread(long long n, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, vector_trace_kernel, THREADS, 0);
  if (err != cudaSuccess) return err;
  const long long wave =
      (long long)THREADS * WAVES * (sms * per_sm > 0 ? sms * per_sm : 1);
  const long long rays = (n + wave - 1) / wave;
  *out = rays < MAX_RAYS_PER_THREAD ? (int)rays : MAX_RAYS_PER_THREAD;
  return cudaSuccess;
}

}  // namespace

// Launch on `stream`: the vector trace of D * R rays (layouts as in Args;
// ray_in holds NIN pointers, ray_out NOUT, in the order of Args).  bounces
// and steps must be zero.  Returns a cudaError_t code (0: launched).
extern "C" int vector_trace_launch(
    const void* rec, const void* cell, const void* dirs, const void* geom,
    const void* fine, const void* sub_codes, const void* const* ray_in,
    void* const* ray_out, void* bounces, void* steps, int D, int R, int C,
    int R2, int num_fc, int num_oc, int ny, int nx, int max_bounces,
    int full, int circle, int grid_n, int sub, int e_ic, int e_r1, int e_r2,
    int e_hull, void* stream) {
  if (D < 1 || R < 0 || C < 1 || R2 != 2 * (1 + num_fc + num_oc) ||
      num_fc < 1 || num_oc < 1 || ny < 1 || nx < 1 || grid_n < 1 ||
      sub < 1 || e_ic < 0 || e_r1 < 0 || e_r2 < 0 || e_hull < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  int rays = 0;
  cudaError_t err = rays_per_thread((long long)D * R, &rays);
  if (err != cudaSuccess) return (int)err;
  const int range = THREADS * rays;
  const long long per = (R + (long long)range - 1) / range;
  if (per * D > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.rec = static_cast<const float*>(rec);
  a.cell = static_cast<const float*>(cell);
  a.dirs = static_cast<const float*>(dirs);
  a.geom = static_cast<const float*>(geom);
  a.fine = static_cast<const int16_t*>(fine);
  a.sub_codes = static_cast<const uint8_t*>(sub_codes);
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
  a.sub = sub;
  a.e_ic = e_ic;
  a.e_r1 = e_r1;
  a.e_r2 = e_r2;
  a.e_hull = e_hull;
  a.range = range;
  a.blocks_per_design = (int)per;
  vector_trace_kernel<<<(unsigned)(per * D), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// What the card makes of the kernel: out = (resident blocks per SM,
// registers and local bytes a thread, threads a block, the most rays a
// block's range holds).
extern "C" int vector_trace_occupancy(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, vector_trace_kernel);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  out[3] = THREADS;
  out[4] = THREADS * MAX_RAYS_PER_THREAD;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], vector_trace_kernel, THREADS, 0);
}

extern "C" const char* vector_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
