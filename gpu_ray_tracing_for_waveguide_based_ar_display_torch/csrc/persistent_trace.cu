// Persistent-slot Monte-Carlo waveguide trace for NVIDIA Hopper (sm_90a).
//
// Replaces engine/trace_pallas_persistent.py::make_persistent_trace_fn of the
// JAX package (the TPU kernel) with exact parameter selection and one cell
// per block, in both spawn modes and with per-design geometry rows.  The
// plain PyTorch version of the same function is
// engine/trace_persistent.py::persistent_trace_reference; the two use the same
// float32 operations in the same order.  Build with -fmad=false so that no
// multiply-add is contracted: then both give identical histograms and counts.
//
// Design (one thread block per (design, wavelength, FoV) cell):
//   * the cell row (704 floats), the cell's design's geometry row (320
//     floats), the state of every slot (12 words each) and the cell's
//     (ny, nx) histogram of integer counts live in dynamic shared memory;
//     each thread owns S / blockDim slots, strided by blockDim;
//   * the grid is D contiguous runs of cpd = C / D cells: block `cell` reads
//     geometry row cell / cpd, launch tile cell / rays_div and seed block
//     cell % rng_mod, so one tile per design and one seed block shared by
//     every design serve a whole sweep chunk without copies;
//   * count spawn (gens_mode 0): iterations run in lockstep across the
//     block, as the TPU kernel's count-spawn schedule does: at the start of
//     iteration `it` a dead slot respawns if the cell's spawn count, as it
//     stood at the start of the iteration, is below ctrl[0], or if
//     it < ctrl[1]; the count starts at S and grows by warp-reduced shared
//     atomics; the block stops when every slot is dead and the target is
//     met, or at max_iters;
//   * gens spawn (gens_mode 1): each slot carries its own generation count
//     (1 after the first spawn); a dead slot respawns while gen < ctrl[0] or
//     it < ctrl[1] (saturating spawn), and the block stops when every slot is
//     dead with gen >= ctrl[0] and it >= ctrl[1], or at max_iters; nb[2] is
//     the sum of the slots' generations;
//   * FC / OC strip records are read by index (the TPU kernel's one-hot
//     selection gives the same values); edge loops stop at the region's real
//     edge count;
//   * a deposit is an integer atomicAdd into the shared tile: exact and
//     independent of order; the tile is written out once.
// What bounds it: per-lane divergent ALU work, block barriers (two per
// iteration in count mode, one in gens mode) and, in saturating spawn, the
// drain tail after ctrl[1].  It reads its rows and rays once and writes one
// tile, so HBM traffic is small beside the ALU work.

#include "trace_common.cuh"

namespace {

constexpr int STATE_WORDS = 12;

struct Args {
  const float* cell_params;  // (C, PC)
  const float* geom_row;     // (D, PG), row cell / cpd
  const float* rays_in;      // (C / rays_div, 6, S), tile cell / rays_div
  const uint32_t* rng_in;    // (rng_mod, S), block cell % rng_mod
  const int* ctrl;           // (2,) [target or generations, spawn_iters]
  float* hist;               // (C, ny, nx)
  int* nb;                   // (C, 4) [bounces, iterations, spawned, 0]
  int cpd, rays_div, rng_mod;
  int S, num_fc, num_oc, n_hull, n_r1, n_r2, ny, nx, max_iters;
};

// GENS selects the spawn mode at compile time: the count path carries no
// per-slot test of the mode (one library, two instantiations)
template <bool GENS>
__global__ void __launch_bounds__(512)
persistent_trace_kernel(Args a) {
  extern __shared__ float smem[];
  const int S = a.S;
  const int ny = a.ny, nx = a.nx;
  float* cp = smem;                     // PC + ZPAD
  float* g = cp + PC + ZPAD;            // PG
  unsigned* tile = reinterpret_cast<unsigned*>(g + PG);  // ny * nx
  float* s_x = reinterpret_cast<float*>(tile + ny * nx);
  float* s_y = s_x + S;
  float* s_ter = s_y + S;
  float* s_tei = s_ter + S;
  float* s_tmr = s_tei + S;
  float* s_tmi = s_tmr + S;
  float* s_cos = s_tmi + S;
  float* s_gx = s_cos + S;
  float* s_gy = s_gx + S;
  int* s_state = reinterpret_cast<int*>(s_gy + S);
  uint32_t* s_rng = reinterpret_cast<uint32_t*>(s_state + S);
  int* s_gen = reinterpret_cast<int*>(s_rng + S);
  __shared__ int s_spawned;
  __shared__ int s_bounces;

  const int cell = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  constexpr bool gens_mode = GENS;
  const float* crow = a.cell_params + (size_t)cell * PC;
  const float* grow = a.geom_row + (size_t)(cell / a.cpd) * PG;
  const float* rays = a.rays_in + (size_t)(cell / a.rays_div) * 6 * S;
  const uint32_t* seeds = a.rng_in + (size_t)(cell % a.rng_mod) * S;

  for (int j = tid; j < PC + ZPAD; j += nt) cp[j] = j < PC ? crow[j] : 0.0f;
  for (int j = tid; j < PG; j += nt) g[j] = grow[j];
  for (int j = tid; j < ny * nx; j += nt) tile[j] = 0u;
  for (int i = tid; i < S; i += nt) {
    s_x[i] = rays[i];
    s_y[i] = rays[S + i];
    s_ter[i] = rays[2 * S + i];
    s_tei[i] = rays[3 * S + i];
    s_tmr[i] = rays[4 * S + i];
    s_tmi[i] = rays[5 * S + i];
    s_cos[i] = 1.0f;
    s_gx[i] = 0.0f;
    s_gy[i] = 0.0f;
    s_state[i] = 7;  // awaiting (re)spawn
    s_rng[i] = seeds[i];
    if (gens_mode) s_gen[i] = 1;    // the first spawn is generation 1
  }
  if (tid == 0) {
    // count mode: every slot's first spawn counts toward the target;
    // gens mode: the generations are summed at the end
    s_spawned = gens_mode ? 0 : S;
    s_bounces = 0;
  }
  const int quota = a.ctrl[0];
  const int spawn_iters = a.ctrl[1];
  const float* zeros = cp + PC;
  __syncthreads();

  int my_bounces = 0;
  int it = 0;
  for (;;) {
    const int sp = gens_mode ? 0 : s_spawned;
    int running = 0;
    for (int i = tid; i < S; i += nt) {
      const bool met = gens_mode ? s_gen[i] >= quota : sp >= quota;
      if (!(s_state[i] == 6 && met && it >= spawn_iters)) running = 1;
    }
    // In count mode this barrier also makes every thread read `sp` before
    // any thread adds to it.  Gens mode needs no other barrier: a thread
    // reads and writes only the slots it owns.
    running = __syncthreads_or(running);
    if (!running || it >= a.max_iters) break;

    int my_respawns = 0;
    for (int i = tid; i < S; i += nt) {
      int state = s_state[i];
      uint32_t rng = s_rng[i];
      float x = s_x[i], y = s_y[i];
      float ter = s_ter[i], tei = s_tei[i], tmr = s_tmr[i], tmi = s_tmi[i];
      float cos_th = s_cos[i], gx = s_gx[i], gy = s_gy[i];

      // ---- respawn
      if (state == 6) {
        if (gens_mode) {
          const int gen = s_gen[i];
          if (gen < quota || it < spawn_iters) {
            state = 7;
            s_gen[i] = gen + 1;
          }
        } else if (sp < quota || it < spawn_iters) {
          state = 7;
          ++my_respawns;
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
          gx = cp[GAPS + 0];
          gy = cp[GAPS + 1];
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
            gx = cp[GAPS + 4];
            gy = cp[GAPS + 5];
          }
          cos_th = cp[IC_SB];
        }
        state = st1;
      }

      // ---- one bounce
      if (state < 6) {
        ++my_bounces;
        if (!region(g, G_R1, a.n_r1, x, y)) state = 6;
      }
      if (state < 6) {
        const bool grp_ic = state <= 1;
        const bool grp_fc = state == 2 || state == 3;
        const bool grp_oc = state >= 4;
        const int bit = state & 1;
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
          in_hull = region(g, G_HULL, a.n_hull, x, y);
          const float yrot = g[G_FC_ROT] * x + g[G_FC_ROT + 1] * y;
          const int k = bin_index((g[G_FC_TOP] - yrot) * g[G_FC_INVW],
                                  a.num_fc - 1);
          const int base = FC_BLK + FC_STRIDE * k;
          ja = cp + base + 16 * bit;
          s_a = cp[base + 32];
          s_b = cp[base + 33];
          interact = in_hull;
        } else {
          in_rect = x >= g[G_OC_BT] && x <= g[G_OC_BT + 1] &&
                    y >= g[G_OC_BT + 2] && y <= g[G_OC_BT + 3];
          const float yr = g[G_OC_ROT] * x + g[G_OC_ROT + 1] * y;
          const int k = bin_index((g[G_OC_TOP] - yr) * g[G_OC_INVW],
                                  a.num_oc - 1);
          const int base = OC_BLK + OC_STRIDE * k;
          ja = cp + base + 24 * bit;
          jc = ja + 16;
          s_a = cp[base + 48];
          s_b = cp[base + 49];
          interact = in_rect;
        }

        if (interact) {
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
            gx = cp[GAPS + 2 * dir];
            gy = cp[GAPS + 1 + 2 * dir];
            x = x + gx;
            y = y + gy;
            const bool icin = in_ic(g, x, y);
            state = br_a ? (grp_oc ? 4 : (grp_fc ? 2 : (icin ? 0 : 2)))
                         : (grp_oc ? 5 : (grp_fc ? 3 : (icin ? 1 : 6)));
          } else {
            if (br_c && x >= cp[EBT] && x <= cp[EBT + 1] &&
                y >= cp[EBT + 2] && y <= cp[EBT + 3]) {
              const int ix = bin_index((x - cp[EBR]) * cp[EBS], nx - 1);
              const int iy = bin_index((y - cp[EBR + 2]) * cp[EBS + 1], ny - 1);
              atomicAdd(&tile[iy * nx + ix], 1u);
            }
            state = 6;  // out-coupled or absorbed
          }
        } else {
          // misses: TIR hop, FC fold-out to the OC, or OC exit
          bool hop = false;
          int hb = 2;  // hop phasor of direction 1
          if (grp_fc) {
            if (state == 2) {
              hop = true;
              hb = 0;
            } else if (region(g, G_R2, a.n_r2, x, y)) {
              hop = true;
            } else {
              state = 4;
            }
          } else if (state == 4) {
            hop = true;
          } else {
            state = 6;
          }
          if (hop) {
            const float h_phr = cp[HOP2_PH + hb];
            const float h_phi = cp[HOP2_PH + hb + 1];
            const float nr = h_phr * tmr - h_phi * tmi;
            const float ni = h_phr * tmi + h_phi * tmr;
            tmr = nr;
            tmi = ni;
            x = x + gx;
            y = y + gy;
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
      s_gx[i] = gx;
      s_gy[i] = gy;
    }
    ++it;
    if (!gens_mode) {
      // count mode's second barrier: the spawn count is complete before the
      // next iteration reads it (the first keeps reads before the adds)
      const int warp_respawns = __reduce_add_sync(0xffffffffu, my_respawns);
      if ((tid & 31) == 0 && warp_respawns)
        atomicAdd(&s_spawned, warp_respawns);
      __syncthreads();
    }
  }

  const int warp_bounces = __reduce_add_sync(0xffffffffu, my_bounces);
  if ((tid & 31) == 0 && warp_bounces) atomicAdd(&s_bounces, warp_bounces);
  if (gens_mode) {
    int my_gens = 0;
    for (int i = tid; i < S; i += nt) my_gens += s_gen[i];
    const int warp_gens = __reduce_add_sync(0xffffffffu, my_gens);
    if ((tid & 31) == 0) atomicAdd(&s_spawned, warp_gens);
  }
  __syncthreads();
  float* out = a.hist + (size_t)cell * ny * nx;
  for (int j = tid; j < ny * nx; j += nt) out[j] = (float)tile[j];
  if (tid == 0) {
    int* nb = a.nb + (size_t)cell * 4;
    nb[0] = s_bounces;
    nb[1] = it;
    nb[2] = s_spawned;
    nb[3] = 0;
  }
}

}  // namespace

extern "C" int persistent_trace_launch(
    const void* cell_params, const void* geom_row, const void* rays_in,
    const void* rng_in, const void* ctrl, void* hist, void* nb, int C,
    int cpd, int rays_div, int rng_mod, int gens_mode, int S, int num_fc,
    int num_oc, int n_hull, int n_r1, int n_r2, int ny, int nx, int max_iters,
    int threads, void* stream) {
  if (C <= 0) return 0;
  if (threads <= 0 || threads > 512 || threads % 32 != 0 || S % threads != 0)
    return (int)cudaErrorInvalidValue;
  if (cpd <= 0 || C % cpd != 0 || rays_div <= 0 || rng_mod <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.cell_params = static_cast<const float*>(cell_params);
  a.geom_row = static_cast<const float*>(geom_row);
  a.rays_in = static_cast<const float*>(rays_in);
  a.rng_in = static_cast<const uint32_t*>(rng_in);
  a.ctrl = static_cast<const int*>(ctrl);
  a.hist = static_cast<float*>(hist);
  a.nb = static_cast<int*>(nb);
  a.cpd = cpd;
  a.rays_div = rays_div;
  a.rng_mod = rng_mod;
  a.S = S;
  a.num_fc = num_fc;
  a.num_oc = num_oc;
  a.n_hull = n_hull;
  a.n_r1 = n_r1;
  a.n_r2 = n_r2;
  a.ny = ny;
  a.nx = nx;
  a.max_iters = max_iters;
  const size_t smem =
      sizeof(float) * ((size_t)PC + ZPAD + PG + (size_t)ny * nx +
                       (size_t)STATE_WORDS * S);
  void (*kernel)(Args) = gens_mode ? persistent_trace_kernel<true>
                                    : persistent_trace_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* persistent_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
