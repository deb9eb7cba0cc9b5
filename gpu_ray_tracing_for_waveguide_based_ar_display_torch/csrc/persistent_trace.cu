// Persistent-slot Monte-Carlo waveguide trace for NVIDIA Hopper (sm_90a).
//
// Replaces engine/trace_pallas_persistent.py::make_persistent_trace_fn of the
// JAX package (the TPU kernel): exact or bf16-packed parameter selection, one
// or several cells per block, single TIR hops or transit jumps, both spawn
// modes, per-design geometry rows.  The plain PyTorch version of the same
// function is engine/trace_persistent.py::persistent_trace_reference; the two
// use the same float32 operations in the same order.  Build with -fmad=false
// so that no multiply-add is contracted: then both give identical histograms
// and counts.
//
// What bounds it on an H100: per-lane divergent ALU work (region tests, Jones
// products, the branch roulette) and the block's barrier once per iteration,
// where every warp waits for the block's slowest one.  It reads its rows and
// rays once and writes one histogram per cell, so HBM traffic is small beside
// the ALU work (phase 6b's byte bound, 4.5 ms, is the largest).  The design
// answers that in three ways:
//
//   1. A work list of the slots that act.  Each iteration runs only the
//      slots that do something: live ones, ones awaiting their first spawn,
//      and dead ones that respawn.  They sit on a per-cell list of uint16
//      slot indices in shared memory, and a cell's threads take its entries
//      j = tl, tl + ntc, ...; a slot that is exhausted (dead, its quota met,
//      past spawn_iters) never acts again and drops off the list.  So dead
//      slots cost nothing and the live ones fill whole warps: in a drain a
//      block runs a few full warps instead of 16 sparse ones.
//   2. Histograms in device memory.  A deposit is a float atomicAdd of 1.0
//      into the cell's bin of `hist` itself (zeroed by the block before its
//      first barrier).  Out-coupling is rare per bounce, the adds go to L2,
//      and every count stays below 2^24, so each float add is exact and the
//      order of the adds does not matter.  No 38,400 B tile per cell takes
//      shared memory.
//   3. Two 2,048-slot blocks per SM.  Without the tile, and with 9 words of
//      state per slot (10 in gens spawn; the hop vector follows from the
//      state: direction 0 in state 2, 1 in states 3 and 4), a block of 2,048
//      slots takes 86-100 KB, and __launch_bounds__(512, 2) holds a thread to
//      64 registers: two blocks share an SM, 32 warps, and one block's drain
//      overlaps the other's busy iterations (every instantiation but count
//      spawn with several cells per block: see MinBlocks).
//
// Layout (one thread block per k consecutive (design, wavelength, FoV) cells,
// k = 1 unless cells_per_block asks for more):
//   * dynamic shared memory holds each cell's row (704 floats) and, in packed
//     selection, its packed words, the block's design's geometry row (320
//     floats), the transit-jump reciprocals, the slots' state (9 or 10 words
//     each) and two lists of S slot indices (this iteration's and the next);
//   * the block's S slots are k runs of Hs = S / k, one per cell; its threads
//     are k groups of ntc = blockDim / k (a multiple of 32, so a warp serves
//     one cell), and each cell has its own list, list length and counters;
//   * the grid is D contiguous runs of cpd = C / D cells: block b reads
//     geometry row (b * k) / cpd, launch tile b / rays_div and seed block
//     b % rng_mod, so one tile per design and one seed block shared by every
//     design serve a whole sweep chunk without copies.
//
// One barrier per iteration.  While a thread runs entry j of this
// iteration's list it also decides the slot's place in the next one, and a
// warp appends its kept slots with one shared atomicAdd on the next list's
// length (ballot and popcount give each lane its place).  The barrier at the
// end of the iteration publishes the next list and its length; the block
// stops when every cell's next list is empty, or at max_iters.  The lengths
// and respawn counts rotate through three buffers by iteration, so the one
// being filled, the one being read and the one being cleared never coincide.
//   * count spawn (GENS false), lockstep as the TPU kernel's schedule: at the
//     start of iteration `it` a dead slot respawns if its cell's spawn count
//     sp, as it stood at the start of the iteration, is below ctrl[0], or if
//     it < ctrl[1]; sp starts at Hs.  Which slots respawn at it + 1 depends
//     only on their state after iteration it and on sp(it + 1) = sp(it) +
//     the respawns at it, which every thread of the cell knows from the last
//     barrier: so the thread that runs a slot counts its respawn for the next
//     iteration, a warp adds its count into the next buffer, and every thread
//     keeps sp in a register.  No thread reads a count that another adds to
//     in the same iteration.  A cell that is done has an empty list while the
//     block's other cells finish, so its histogram, bounces and spawns equal
//     those of the same cell alone in a block;
//   * gens spawn (GENS true): each slot carries its own generation count
//     (1 after the first spawn); a dead slot respawns while gen < ctrl[0] or
//     it < ctrl[1] (saturating spawn); nb[2] is the sum of the cell's slots'
//     generations;
//   * every sum across threads (bounces, spawns, generations, deposits) is an
//     integer count, so which thread runs which slot changes no output;
//   * exact selection (SEL 0) reads FC / OC strip records from the cell row
//     by index (the TPU kernel's one-hot selection gives the same values);
//     packed selection (SEL >= 1) reads the site's record from the packed
//     words by (record, word) and widens each bf16 half by a 16-bit shift,
//     and tests regions by the max chain max_e(x*nx_e + (y*ny_e + mc_e)) <= 0;
//     edge loops stop at the region's real edge count;
//   * transit jump (SEL 2: phase by squaring, capped at 15 hops; SEL 3: phase
//     by cos / sin, capped at 4095): a slot on a pure TIR hop advances k hops
//     in one iteration, k = the first hop index at which it leaves eff_reg1
//     (or eff_reg2, state 3) or enters the FC hull (states 2, 3) or the OC
//     rectangle (state 4).  The per-edge slopes of the two hop lines and
//     their guarded reciprocals are computed once per block into shared
//     memory before the first iteration; the region tests on this path also
//     return the bound.

#include <math.h>

#include "trace_common.cuh"

namespace {

constexpr int STATE_WORDS = 9;   // x, y, ter, tei, tmr, tmi, cos, state, rng
constexpr int MAX_CPB = 8;       // cells one block can carry
constexpr int SEL_NW = 25;       // packed words of one selection record
// transit-jump reciprocals in shared memory: eff_reg1 exit and hull entry
// for hop directions 0 and 1, eff_reg2 exit for direction 1, and the signed
// reciprocals of direction 1's gap
constexpr int J_REX_R1 = 0, J_REN_H = 2 * MAX_EDGES, J_REX_R2 = 4 * MAX_EDGES,
              J_RGAP = 5 * MAX_EDGES, JUMP_WORDS = 5 * MAX_EDGES + 8;

struct Args {
  const float* cell_params;  // (C, PC)
  const float* geom_row;     // (D, PG), row (block * k) / cpd
  const float* rays_in;      // (R, 6, S), tile block / rays_div
  const uint32_t* rng_in;    // (rng_mod, S), seed block block % rng_mod
  const int* ctrl;           // (2,) [target or generations, spawn_iters]
  const int* packed;         // (C, pw) packed selection words, or null
  float* hist;               // (C, ny, nx)
  int* nb;                   // (C, 4) [bounces, iterations, spawned, 0]
  int cpd, rays_div, rng_mod, k, pw;
  int S, num_fc, num_oc, n_hull, n_r1, n_r2, ny, nx, max_iters;
};

// Dynamic shared memory of one block: per cell a cell row (with its zero
// pad) and its packed words, the geometry row, the jump reciprocals, the
// slots' state words (and generations) and two lists of uint16 indices.
size_t shared_bytes(bool gens, int sel, int k, int pw, int S) {
  return sizeof(float) * ((size_t)k * (PC + ZPAD + pw) + PG +
                          (sel >= 2 ? JUMP_WORDS : 0) +
                          (size_t)(STATE_WORDS + (gens ? 1 : 0)) * S) +
         sizeof(uint16_t) * 2 * (size_t)S;
}

// the two bfloat16 halves of a packed word, widened to float32
__device__ __forceinline__ float bf16_lo(int w) {
  return __uint_as_float((unsigned)w << 16);
}

__device__ __forceinline__ float bf16_hi(int w) {
  return __uint_as_float((unsigned)w & 0xffff0000u);
}

// four packed words -> one 2x2 complex Jones matrix (8 floats)
__device__ __forceinline__ void unpack_jones(const int* w, float* o) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    o[2 * j] = bf16_lo(w[j]);
    o[2 * j + 1] = bf16_hi(w[j]);
  }
}

// packed selection's containment test: max_e(x*nx_e + (y*ny_e + mc_e)) <= 0
__device__ __forceinline__ bool region_max(const float* g, int base, int mc,
                                           int n, float x, float y) {
  for (int e = 0; e < n; ++e) {
    if (!(x * g[base + e] + (y * g[base + MAX_EDGES + e] + g[mc + e]) <= 0.0f))
      return false;
  }
  return true;
}

// The same test with the transit bound along the slot's hop line: d_e * r_e
// per edge, reduced by min (EXIT: the hop index at which the first edge is
// crossed outward, for a slot inside) or by max (entry: the hop index from
// which every edge is satisfied).
template <bool EXIT>
__device__ __forceinline__ bool region_bound(const float* g, int base, int mc,
                                             int n, float x, float y,
                                             const float* r, float* bound) {
  float m = -INFINITY;
  float b = EXIT ? INFINITY : -INFINITY;
  for (int e = 0; e < n; ++e) {
    const float d =
        x * g[base + e] + (y * g[base + MAX_EDGES + e] + g[mc + e]);
    m = fmaxf(m, d);
    const float u = d * r[e];
    b = EXIT ? fminf(b, u) : fmaxf(b, u);
  }
  *bound = b;
  return m <= 0.0f;
}

// Blocks of 512 threads that share an SM, __launch_bounds__'s second
// argument: 2 holds a thread to 64 registers.  Count spawn with several cells
// per block spills at 64 (ptxas: 20-44 B of spill traffic), so it keeps one
// block per SM and takes the registers it needs (72); it is off the main
// path (cells_per_block > 1 only).
template <bool GENS, int SEL, bool MULTI>
struct MinBlocks {
  static constexpr int value = (!GENS && MULTI) ? 1 : 2;
};

// GENS (the spawn mode), SEL (0 exact selection, 1 packed, 2 packed with
// transit jumps phased by squaring, 3 the same phased by cos / sin) and MULTI
// (several cells per block) are compile-time: the exact count path carries no
// test of any of them (one library, one instantiation per combination in use)
template <bool GENS, int SEL, bool MULTI>
__global__ void __launch_bounds__(512, (MinBlocks<GENS, SEL, MULTI>::value))
persistent_trace_kernel(Args a) {
  constexpr bool PACKED = SEL >= 1;
  constexpr bool JUMP = SEL >= 2;
  extern __shared__ float smem[];
  const int S = a.S;
  const int ny = a.ny, nx = a.nx;
  const int k = MULTI ? a.k : 1;
  const int pw = PACKED ? a.pw : 0;
  float* cps = smem;                          // k x (PC + ZPAD)
  float* g = cps + k * (PC + ZPAD);           // PG
  int* pks = reinterpret_cast<int*>(g + PG);  // k x pw
  float* jmp = reinterpret_cast<float*>(pks + k * pw);   // JUMP_WORDS
  float* s_x = jmp + (JUMP ? JUMP_WORDS : 0);
  float* s_y = s_x + S;
  float* s_ter = s_y + S;
  float* s_tei = s_ter + S;
  float* s_tmr = s_tei + S;
  float* s_tmi = s_tmr + S;
  float* s_cos = s_tmi + S;
  int* s_state = reinterpret_cast<int*>(s_cos + S);
  uint32_t* s_rng = reinterpret_cast<uint32_t*>(s_state + S);
  int* s_gen = reinterpret_cast<int*>(s_rng + S);        // gens spawn only
  // slot indices fit 16 bits: a block's shared memory holds < 6,500 slots
  uint16_t* lists = reinterpret_cast<uint16_t*>(s_gen + (GENS ? S : 0));
  // by iteration mod 3: each cell's list length and, in count spawn, the
  // respawns at the start of that iteration
  __shared__ int s_live[3][MAX_CPB];
  __shared__ int s_resp[3][MAX_CPB];
  __shared__ int s_spawned[MAX_CPB];
  __shared__ int s_bounces[MAX_CPB];
  __shared__ int s_ctrl[2];   // ctrl, read where it is used

  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nt = blockDim.x;
  // this thread's cell of the block, its group of threads and its slots
  const int ntc = MULTI ? nt / k : nt;     // threads per cell
  const int h = MULTI ? tid / ntc : 0;     // cell of the block
  const int tl = MULTI ? tid - h * ntc : tid;
  const int Hs = MULTI ? S / k : S;        // slots per cell
  const int s0 = h * Hs;
  const int cell0 = blk * k;
  const float* grow = a.geom_row + (size_t)(cell0 / a.cpd) * PG;
  const float* rays = a.rays_in + (size_t)(blk / a.rays_div) * 6 * S;
  const uint32_t* seeds = a.rng_in + (size_t)(blk % a.rng_mod) * S;
  float* hist = a.hist + (size_t)cell0 * ny * nx;   // the block's cells'

  for (int c = 0; c < k; ++c) {
    const float* crow = a.cell_params + (size_t)(cell0 + c) * PC;
    for (int j = tid; j < PC + ZPAD; j += nt)
      cps[c * (PC + ZPAD) + j] = j < PC ? crow[j] : 0.0f;
    if (PACKED) {
      const int* prow = a.packed + (size_t)(cell0 + c) * pw;
      for (int j = tid; j < pw; j += nt) pks[c * pw + j] = prow[j];
    }
  }
  for (int j = tid; j < PG; j += nt) g[j] = grow[j];
  // the block's own cells' histograms; the barrier below orders these
  // stores before every deposit
  for (int j = tid; j < k * ny * nx; j += nt) hist[j] = 0.0f;
  for (int i = tid; i < S; i += nt) {
    s_x[i] = rays[i];
    s_y[i] = rays[S + i];
    s_ter[i] = rays[2 * S + i];
    s_tei[i] = rays[3 * S + i];
    s_tmr[i] = rays[4 * S + i];
    s_tmi[i] = rays[5 * S + i];
    s_cos[i] = 1.0f;
    s_state[i] = 7;  // awaiting (re)spawn
    s_rng[i] = seeds[i];
    if (GENS) s_gen[i] = 1;    // the first spawn is generation 1
    lists[i] = (uint16_t)i;    // iteration 0 runs every slot
  }
  if (tid < k) {
    // count mode: every slot's first spawn counts toward the target;
    // gens mode: the generations are summed at the end
    for (int b = 0; b < 3; ++b) {
      s_live[b][tid] = b == 0 ? Hs : 0;
      s_resp[b][tid] = 0;
    }
    s_spawned[tid] = 0;
    s_bounces[tid] = 0;
  }
  if (tid < 2) s_ctrl[tid] = a.ctrl[tid];
  const float* cp = cps + h * (PC + ZPAD);
  const int* pk = pks + h * pw;
  const float* zeros = cp + PC;
  __syncthreads();

  if (JUMP) {
    // per-edge slopes of the hop lines (direction 0: state 2, direction 1:
    // states 3 and 4) and their guarded reciprocals.  Exit: the first hop
    // index past edge e is floor(d_e * rex_e) + 1 with rex_e = -1 / max(s_e,
    // tiny); receding or parallel edges give a huge positive that never wins
    // the min.  Entry: edge e holds from hop d_e * ren_e on, ren_e = 1 /
    // max(-s_e, tiny).
    for (int e = tid; e < MAX_EDGES; e += nt) {
      for (int d = 0; d < 2; ++d) {
        const float gxd = cp[GAPS + 2 * d], gyd = cp[GAPS + 2 * d + 1];
        const float s1 = g[G_R1 + e] * gxd + g[G_R1 + MAX_EDGES + e] * gyd;
        const float sh = g[G_HULL + e] * gxd + g[G_HULL + MAX_EDGES + e] * gyd;
        jmp[J_REX_R1 + d * MAX_EDGES + e] = -1.0f / fmaxf(s1, 1e-30f);
        jmp[J_REN_H + d * MAX_EDGES + e] = 1.0f / fmaxf(-sh, 1e-30f);
        if (d == 1) {
          const float s2 = g[G_R2 + e] * gxd + g[G_R2 + MAX_EDGES + e] * gyd;
          jmp[J_REX_R2 + e] = -1.0f / fmaxf(s2, 1e-30f);
        }
      }
    }
    if (tid < 2) {
      // OC rectangle slab along direction 1: sign-preserving reciprocals of
      // the gap's components, their magnitude clamped away from zero
      const float gc = cp[GAPS + 2 + tid];
      jmp[J_RGAP + tid] = (gc >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(gc), 1e-12f);
    }
    __syncthreads();
  }

  int my_bounces = 0;
  int sp = Hs;   // count spawn: the cell's spawn count at the start of `it`
  int it = 0;
  for (;;) {
    // the lengths and respawn counts of this iteration were published by
    // the last barrier; every thread takes the same decision here
    const int cur = it % 3, nxt = (it + 1) % 3;
    bool running = false;
    for (int c = 0; c < k; ++c) running |= s_live[cur][c] > 0;
    if (!running || it >= a.max_iters) break;
    const int n = s_live[cur][h];
    const int sp_next = GENS ? 0 : sp + s_resp[cur][h];
    if (tid < k) {
      // read last in iteration it - 1, filled next in iteration it + 1
      s_live[(it + 2) % 3][tid] = 0;
      s_resp[(it + 2) % 3][tid] = 0;
    }
    const uint16_t* list = lists + (it & 1) * S + s0;
    uint16_t* next = lists + ((it + 1) & 1) * S + s0;

    int my_resp = 0;   // count spawn: this thread's respawns at it + 1
    // the rounds are warp-uniform: every lane reaches the ballot
    for (int e0 = tl - lane; e0 < n; e0 += ntc) {
      const int j = e0 + lane;
      bool keep = false;
      int i = 0;
      if (j < n) {
        i = list[j];
        int state = s_state[i];
        uint32_t rng = s_rng[i];
        float x = s_x[i], y = s_y[i];
        float ter = s_ter[i], tei = s_tei[i], tmr = s_tmr[i], tmi = s_tmi[i];
        float cos_th = s_cos[i];
        int gen = GENS ? s_gen[i] : 0;

        // ---- respawn
        if (state == 6) {
          if (GENS) {
            if (gen < s_ctrl[0] || it < s_ctrl[1]) {
              state = 7;
              s_gen[i] = ++gen;
            }
          } else if (sp < s_ctrl[0] || it < s_ctrl[1]) {
            state = 7;
          }
        }

        // ---- init: first IC interaction from the slot's launch fields
        if (state == 7) {
          const float x0 = rays[i], y0 = rays[S + i];
          const float ter0 = rays[2 * S + i], tei0 = rays[3 * S + i];
          const float tmr0 = rays[4 * S + i], tmi0 = rays[5 * S + i];
          float pa[4], pb[4];
          jones(cp + INIT_JA, ter0, tei0, tmr0, tmi0, pa);
          jones(cp + INIT_JB, ter0, tei0, tmr0, tmi0, pb);
          const float inv_cos0 = 1.0f / cp[INIT_COS0];
          const float eff_a0 = power4(pa) * cp[INIT_SA] * inv_cos0;
          const float eff_ab0 = eff_a0 + power4(pb) * cp[INIT_SB] * inv_cos0;
          rng = xorshift32(rng);
          const float u = draw24(rng);
          const bool br_a = u <= eff_a0;
          const bool br_b = !br_a && u <= eff_ab0;
          int st1;
          if (br_a) {
            const float x1 = x0 + cp[GAPS + 0], y1 = y0 + cp[GAPS + 1];
            st1 = in_ic(g, x1, y1) ? 0 : 2;
            const float inv = rsqrt_ieee(power4(pa));
            const float tr = pa[2] * inv, ti = pa[3] * inv;
            x = x1;
            y = y1;
            ter = pa[0] * inv;
            tei = pa[1] * inv;
            tmr = cp[TIR_PH + 0] * tr - cp[TIR_PH + 1] * ti;
            tmi = cp[TIR_PH + 0] * ti + cp[TIR_PH + 1] * tr;
            cos_th = cp[IC_SA];
          } else {
            const float x1 = x0 + cp[GAPS + 4], y1 = y0 + cp[GAPS + 5];
            st1 = (br_b && in_ic(g, x1, y1)) ? 1 : 6;
            if (st1 == 1) {
              const float inv = rsqrt_ieee(power4(pb));
              const float tr = pb[2] * inv, ti = pb[3] * inv;
              x = x1;
              y = y1;
              ter = pb[0] * inv;
              tei = pb[1] * inv;
              tmr = cp[TIR_PH + 4] * tr - cp[TIR_PH + 5] * ti;
              tmi = cp[TIR_PH + 4] * ti + cp[TIR_PH + 5] * tr;
            }
            cos_th = cp[IC_SB];
          }
          state = st1;
        }

        // ---- one bounce
        // transit bounds along the slot's hop line (direction 0 for state 2,
        // else 1); only the states that hop read them
        const int jd = state == 2 ? 0 : 1;
        float ex_r1 = 0.0f, en_hull = 0.0f;
        if (state < 6) {
          ++my_bounces;
          bool in_r1;
          if (JUMP)
            in_r1 = region_bound<true>(g, G_R1, G_MC_R1, a.n_r1, x, y,
                                       jmp + J_REX_R1 + jd * MAX_EDGES, &ex_r1);
          else if (PACKED)
            in_r1 = region_max(g, G_R1, G_MC_R1, a.n_r1, x, y);
          else
            in_r1 = region(g, G_R1, a.n_r1, x, y);
          if (!in_r1) state = 6;
        }
        if (state < 6) {
          const bool grp_ic = state <= 1;
          const bool grp_fc = state == 2 || state == 3;
          const bool grp_oc = state >= 4;
          const int bit = state & 1;
          float rec[24];   // packed selection: the site's unpacked record
          const int* words = pk;
          const float* ja;
          const float* jc = zeros;
          float s_a, s_b;
          bool interact;
          bool in_hull = false, in_rect = false;
          if (grp_ic) {
            ja = cp + IC_BLK + 16 * bit;
            s_a = cp[IC_SA];
            s_b = cp[IC_SB];
            interact = true;
          } else if (grp_fc) {
            if (JUMP)
              in_hull = region_bound<false>(g, G_HULL, G_MC_HULL, a.n_hull, x,
                                            y, jmp + J_REN_H + jd * MAX_EDGES,
                                            &en_hull);
            else if (PACKED)
              in_hull = region_max(g, G_HULL, G_MC_HULL, a.n_hull, x, y);
            else
              in_hull = region(g, G_HULL, a.n_hull, x, y);
            const float yrot = g[G_FC_ROT] * x + g[G_FC_ROT + 1] * y;
            const int strip = bin_index((g[G_FC_TOP] - yrot) * g[G_FC_INVW],
                                        a.num_fc - 1);
            const int base = FC_BLK + FC_STRIDE * strip;
            words = pk + (1 + strip) * SEL_NW;
            ja = cp + base + 16 * bit;
            s_a = cp[base + 32];
            s_b = cp[base + 33];
            interact = in_hull;
          } else {
            in_rect = x >= g[G_OC_BT] && x <= g[G_OC_BT + 1] &&
                      y >= g[G_OC_BT + 2] && y <= g[G_OC_BT + 3];
            const float yr = g[G_OC_ROT] * x + g[G_OC_ROT + 1] * y;
            const int strip = bin_index((g[G_OC_TOP] - yr) * g[G_OC_INVW],
                                        a.num_oc - 1);
            const int base = OC_BLK + OC_STRIDE * strip;
            words = pk + (1 + a.num_fc + strip) * SEL_NW;
            ja = cp + base + 24 * bit;
            jc = ja + 16;
            s_a = cp[base + 48];
            s_b = cp[base + 49];
            interact = in_rect;
          }

          if (interact) {
            if (PACKED) {
              // record words 0-3 A | bit 0, 4-7 B | bit 0, 8-11 A | bit 1,
              // 12-15 B | bit 1, 16 (s_a, s_b), 17-20 C | bit 0, 21-24 C |
              // bit 1 (zero on IC and FC records)
              unpack_jones(words + 8 * bit, rec);
              unpack_jones(words + 4 + 8 * bit, rec + 8);
              unpack_jones(words + 17 + 4 * bit, rec + 16);
              ja = rec;
              jc = rec + 16;
              s_a = bf16_lo(words[16]);
              s_b = bf16_hi(words[16]);
            }
            float pa[4], pb[4], pc[4];
            jones(ja, ter, tei, tmr, tmi, pa);
            jones(ja + 8, ter, tei, tmr, tmi, pb);
            jones(jc, ter, tei, tmr, tmi, pc);
            const float inv_cos = 1.0f / cos_th;
            const float eff_a = power4(pa) * s_a * inv_cos;
            const float eff_b = power4(pb) * s_b * inv_cos;
            const float eff_c = power4(pc) * cp[OC_SOUT] * inv_cos;
            rng = xorshift32(rng);
            const float u = draw24(rng);
            const bool br_a = u <= eff_a && eff_a > 0.0f;
            const bool br_b = !br_a && u <= eff_a + eff_b && eff_b > 0.0f;
            const bool br_c = grp_oc && !br_a && !br_b &&
                              u <= eff_a + eff_b + eff_c && eff_c > 0.0f;
            if (br_a || br_b) {
              const int dir = br_a ? (grp_oc ? 1 : 0)
                                   : (grp_oc ? 3 : (grp_fc ? 1 : 2));
              const float* pn = br_a ? pa : pb;
              const float inv = rsqrt_ieee(power4(pn));
              const float phr = cp[TIR_PH + 2 * dir];
              const float phi = cp[TIR_PH + 1 + 2 * dir];
              const float tr = pn[2] * inv, ti = pn[3] * inv;
              ter = pn[0] * inv;
              tei = pn[1] * inv;
              tmr = phr * tr - phi * ti;
              tmi = phr * ti + phi * tr;
              cos_th = br_a ? s_a : s_b;
              x = x + cp[GAPS + 2 * dir];
              y = y + cp[GAPS + 1 + 2 * dir];
              const bool icin = in_ic(g, x, y);
              state = br_a ? (grp_oc ? 4 : (grp_fc ? 2 : (icin ? 0 : 2)))
                           : (grp_oc ? 5 : (grp_fc ? 3 : (icin ? 1 : 6)));
            } else {
              if (br_c && x >= cp[EBT] && x <= cp[EBT + 1] &&
                  y >= cp[EBT + 2] && y <= cp[EBT + 3]) {
                const int ix = bin_index((x - cp[EBR]) * cp[EBS], nx - 1);
                const int iy =
                    bin_index((y - cp[EBR + 2]) * cp[EBS + 1], ny - 1);
                atomicAdd(&a.hist[((size_t)(cell0 + h) * ny + iy) * nx + ix],
                          1.0f);
              }
              state = 6;  // out-coupled or absorbed
            }
          } else {
            // misses: TIR hop, FC fold-out to the OC, or OC exit
            bool hop = false;
            // hop direction: 0 in state 2, 1 in states 3 and 4; the offset
            // of its gap, phasor and angle pair in the cell row
            int hb = 2;
            // transit jump: the first hop index at which something happens
            float kf = 1.0f;
            if (grp_fc) {
              if (JUMP) kf = fminf(floorf(ex_r1) + 1.0f, ceilf(en_hull));
              if (state == 2) {
                hop = true;
                hb = 0;
              } else {
                bool in_r2;
                float ex_r2 = 0.0f;
                if (JUMP)
                  in_r2 = region_bound<true>(g, G_R2, G_MC_R2, a.n_r2, x, y,
                                             jmp + J_REX_R2, &ex_r2);
                else if (PACKED)
                  in_r2 = region_max(g, G_R2, G_MC_R2, a.n_r2, x, y);
                else
                  in_r2 = region(g, G_R2, a.n_r2, x, y);
                if (in_r2) {
                  hop = true;
                  if (JUMP) kf = fminf(kf, floorf(ex_r2) + 1.0f);
                } else {
                  state = 4;
                }
              }
            } else if (state == 4) {
              hop = true;
              if (JUMP) {
                // OC rectangle entry along direction 1 (slab test)
                const float rgx = jmp[J_RGAP], rgy = jmp[J_RGAP + 1];
                const float t0x = (g[G_OC_BT + 0] - x) * rgx;
                const float t1x = (g[G_OC_BT + 1] - x) * rgx;
                const float t0y = (g[G_OC_BT + 2] - y) * rgy;
                const float t1y = (g[G_OC_BT + 3] - y) * rgy;
                const float en_rect =
                    fmaxf(fminf(t0x, t1x), fminf(t0y, t1y));
                kf = fminf(floorf(ex_r1) + 1.0f, ceilf(en_rect));
              }
            } else {
              state = 6;
            }
            if (hop) {
              float h_phr = cp[HOP2_PH + hb];
              float h_phi = cp[HOP2_PH + hb + 1];
              if (JUMP) {
                // exits happen at floor(u) + 1, entries at ceil(u); one hop
                // at least, and no more than the phase can carry
                kf = fminf(fmaxf(kf, 1.0f), SEL == 2 ? 15.0f : 4095.0f);
                const int ki = (int)kf;
                my_bounces += ki - 1;   // the skipped hops are bounces too
                if (SEL == 2) {
                  // phasor^ki by squaring, four bits
                  float zr = h_phr, zi = h_phi;
                  if (!(ki & 1)) {
                    h_phr = 1.0f;
                    h_phi = 0.0f;
                  }
#pragma unroll
                  for (int b = 2; b <= 8; b <<= 1) {
                    const float zr2 = zr * zr - zi * zi;
                    zi = 2.0f * zr * zi;
                    zr = zr2;
                    if (ki & b) {
                      const float nrr = h_phr * zr - h_phi * zi;
                      const float nri = h_phr * zi + h_phi * zr;
                      h_phr = nrr;
                      h_phi = nri;
                    }
                  }
                } else {
                  const float th = kf * cp[HOP2_ANG + (hb >> 1)];
                  h_phr = cosf(th);
                  h_phi = sinf(th);
                }
              }
              const float nr = h_phr * tmr - h_phi * tmi;
              const float ni = h_phr * tmi + h_phi * tmr;
              tmr = nr;
              tmi = ni;
              const float gx = cp[GAPS + hb], gy = cp[GAPS + hb + 1];
              if (JUMP) {
                x = x + kf * gx;
                y = y + kf * gy;
              } else {
                x = x + gx;
                y = y + gy;
              }
            }
          }
        }

        s_state[i] = state;
        s_rng[i] = rng;
        s_x[i] = x;
        s_y[i] = y;
        s_ter[i] = ter;
        s_tei[i] = tei;
        s_tmr[i] = tmr;
        s_tmi[i] = tmi;
        s_cos[i] = cos_th;

        // ---- the slot's place in iteration it + 1: a live slot stays on
        // the list; a dead one stays if it respawns then (its generations,
        // or the cell's count sp_next, below the quota, or it + 1 <
        // spawn_iters) and is exhausted for good otherwise
        keep = state < 6 || !((GENS ? gen : sp_next) >= s_ctrl[0]) ||
               it + 1 < s_ctrl[1];
        if (!GENS && state == 6 && keep) ++my_resp;
      }
      const unsigned kept = __ballot_sync(0xffffffffu, keep);
      int base = 0;
      if (lane == 0 && kept)
        base = atomicAdd(&s_live[nxt][h], __popc(kept));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (keep) next[base + __popc(kept & ((1u << lane) - 1u))] = (uint16_t)i;
    }
    if (!GENS) {
      const int warp_resp = __reduce_add_sync(0xffffffffu, my_resp);
      if (lane == 0 && warp_resp) atomicAdd(&s_resp[nxt][h], warp_resp);
      sp = sp_next;
    }
    ++it;
    // publishes the next lists, their lengths and respawn counts, and every
    // slot's state
    __syncthreads();
  }

  const int warp_bounces = __reduce_add_sync(0xffffffffu, my_bounces);
  if (lane == 0 && warp_bounces) atomicAdd(&s_bounces[h], warp_bounces);
  if (GENS) {
    int my_gens = 0;
    for (int l = tl; l < Hs; l += ntc) my_gens += s_gen[s0 + l];
    const int warp_gens = __reduce_add_sync(0xffffffffu, my_gens);
    if (lane == 0) atomicAdd(&s_spawned[h], warp_gens);
  } else if (tl == 0) {
    s_spawned[h] = sp;
  }
  __syncthreads();
  if (tid < k) {
    int* nb = a.nb + (size_t)(cell0 + tid) * 4;
    nb[0] = s_bounces[tid];
    nb[1] = it;
    nb[2] = s_spawned[tid];
    nb[3] = 0;
  }
}

// an instantiation and the blocks per SM its launch bounds ask for
struct Kernel {
  void (*fn)(Args);
  int min_blocks;
};

template <bool GENS, int SEL, bool MULTI>
Kernel entry() {
  return {persistent_trace_kernel<GENS, SEL, MULTI>,
          MinBlocks<GENS, SEL, MULTI>::value};
}

template <bool GENS>
Kernel pick_kernel(int sel, bool multi) {
  switch (sel) {
    case 0: return entry<GENS, 0, false>();
    // several cells per block exist for plain packed selection only
    case 1: return multi ? entry<GENS, 1, true>() : entry<GENS, 1, false>();
    case 2: return entry<GENS, 2, false>();
    default: return entry<GENS, 3, false>();
  }
}

Kernel pick(int gens_mode, int sel, int k) {
  return gens_mode ? pick_kernel<true>(sel, k > 1)
                   : pick_kernel<false>(sel, k > 1);
}

}  // namespace

// sel: 0 exact selection, 1 packed, 2 packed + transit jump phased by
// squaring, 3 packed + transit jump phased by cos / sin.  k cells per block
// (k > 1 with sel 1 only); `packed` is (C, pw) words when sel >= 1.
extern "C" int persistent_trace_launch(
    const void* cell_params, const void* geom_row, const void* rays_in,
    const void* rng_in, const void* ctrl, const void* packed, void* hist,
    void* nb, int C, int cpd, int rays_div, int rng_mod, int gens_mode,
    int sel, int k, int pw, int S, int num_fc, int num_oc, int n_hull,
    int n_r1, int n_r2, int ny, int nx, int max_iters, int threads,
    void* stream) {
  if (C <= 0) return 0;
  if (k < 1 || k > MAX_CPB || threads <= 0 || threads > 512 ||
      threads % k != 0 || (threads / k) % 32 != 0 || S % k != 0 ||
      (S / k) % (threads / k) != 0)
    return (int)cudaErrorInvalidValue;
  if (cpd <= 0 || C % cpd != 0 || cpd % k != 0 || rays_div <= 0 ||
      rng_mod <= 0)
    return (int)cudaErrorInvalidValue;
  if (sel < 0 || sel > 3 || (k > 1 && sel != 1) ||
      (sel >= 1 && (packed == nullptr ||
                    pw < (1 + num_fc + num_oc) * SEL_NW)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.cell_params = static_cast<const float*>(cell_params);
  a.geom_row = static_cast<const float*>(geom_row);
  a.rays_in = static_cast<const float*>(rays_in);
  a.rng_in = static_cast<const uint32_t*>(rng_in);
  a.ctrl = static_cast<const int*>(ctrl);
  a.packed = static_cast<const int*>(packed);
  a.hist = static_cast<float*>(hist);
  a.nb = static_cast<int*>(nb);
  a.cpd = cpd;
  a.rays_div = rays_div;
  a.rng_mod = rng_mod;
  a.k = k;
  a.pw = sel >= 1 ? pw : 0;
  a.S = S;
  a.num_fc = num_fc;
  a.num_oc = num_oc;
  a.n_hull = n_hull;
  a.n_r1 = n_r1;
  a.n_r2 = n_r2;
  a.ny = ny;
  a.nx = nx;
  a.max_iters = max_iters;
  const size_t smem = shared_bytes(gens_mode, sel, k, a.pw, S);
  Kernel kernel = pick(gens_mode, sel, k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel.fn<<<C / k, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The instantiation a launch with these arguments runs, at `threads`
// threads: out = [resident blocks per SM (cudaOccupancyMaxActiveBlocks-
// PerMultiprocessor), registers per thread, local memory bytes per thread,
// dynamic shared bytes, static shared bytes, the blocks per SM its launch
// bounds ask for].
extern "C" int persistent_trace_occupancy(int gens_mode, int sel, int k,
                                          int pw, int S, int threads,
                                          int* out) {
  Kernel kernel = pick(gens_mode, sel, k);
  const size_t smem = shared_bytes(gens_mode, sel, k, sel >= 1 ? pw : 0, S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel.fn,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel.fn);
  if (err != cudaSuccess) return (int)err;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)smem;
  out[4] = (int)attr.sharedSizeBytes;
  out[5] = kernel.min_blocks;
  return 0;
}

extern "C" const char* persistent_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
