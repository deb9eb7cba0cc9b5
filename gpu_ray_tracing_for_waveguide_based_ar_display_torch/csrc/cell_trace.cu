// Per-cell Monte-Carlo waveguide trace for NVIDIA Hopper (sm_90a).
//
// Replaces engine/trace_pallas.py::make_pallas_trace_fn (its `kernel`) of the
// JAX package, in both of its modes: every ray of a cell is traced once, from
// its first in-coupler interaction (full mode) or from a saved 9-field state
// (resume mode), until it dies or has run `max_bounces` iterations.  Each ray
// reports at most one deposit code iy * nx + ix (or -1) and its state, fields
// and RNG stream, so a scheduler can compact survivors and resume them.  The
// plain PyTorch version of the same function is
// engine/trace_cell.py::cell_trace_reference; the two use the same float32
// operations in the same order.  Build with -fmad=false so that no
// multiply-add is contracted: then both give identical outputs.
//
// Design: one thread per ray with its state in registers, free-running.  A
// ray's outcome depends only on its own fields, state and RNG stream, so
// there is no barrier inside the loop and a warp runs until its own slowest
// ray ends.  The grid is C runs of S / blockDim blocks; each block copies its
// cell row (704 floats) and the geometry row (320 floats) into shared memory.
// FC / OC strip records are read by index and edge loops stop at the region's
// real edge count.  nb[c] = [bounces, iterations]: each thread counts the
// iterations it began alive, a warp reduces them and adds once (integer
// atomics: the sum is independent of order); iterations is the largest such
// count of the cell.  The caller zeroes nb.
// What bounds it: per-lane divergent ALU work and the wait of each warp for
// its slowest ray; it reads every input once and writes every output once.

#include "trace_common.cuh"

namespace {

struct Args {
  const float* cell_params;  // (C, PC)
  const float* geom_row;     // (PG)
  const float* rays_in;      // (C, 6, S) full mode, (C, 9, S) resume mode
  const int* state_in;       // (C, S) resume mode, nullptr in full mode
  const uint32_t* rng_in;    // (C, S)
  int* dep;                  // (C, S)
  int* nb;                   // (C, 2), zeroed by the caller
  float* rays_out;           // (C, 9, S)
  int* state_out;            // (C, S)
  uint32_t* rng_out;         // (C, S)
  int S, num_fc, num_oc, n_hull, n_r1, n_r2, ny, nx, max_bounces;
};

__global__ void __launch_bounds__(128) cell_trace_kernel(Args a) {
  __shared__ float cp[PC + ZPAD];
  __shared__ float g[PG];
  const int S = a.S;
  const int bps = S / blockDim.x;  // blocks per cell; S % blockDim == 0
  const int cell = blockIdx.x / bps;
  const int tid = threadIdx.x;
  const int i = (blockIdx.x % bps) * blockDim.x + tid;
  const bool resume = a.state_in != nullptr;
  const int nf = resume ? 9 : 6;
  const float* crow = a.cell_params + (size_t)cell * PC;
  for (int j = tid; j < PC + ZPAD; j += blockDim.x)
    cp[j] = j < PC ? crow[j] : 0.0f;
  for (int j = tid; j < PG; j += blockDim.x) g[j] = a.geom_row[j];
  const float* zeros = cp + PC;
  __syncthreads();

  const float* rays = a.rays_in + (size_t)cell * nf * S + i;
  const size_t slot = (size_t)cell * S + i;
  float x = rays[0], y = rays[S];
  float ter = rays[2 * (size_t)S], tei = rays[3 * (size_t)S];
  float tmr = rays[4 * (size_t)S], tmi = rays[5 * (size_t)S];
  float cos_th, gx, gy;
  int state;
  uint32_t rng = a.rng_in[slot];

  if (resume) {
    cos_th = rays[6 * (size_t)S];
    gx = rays[7 * (size_t)S];
    gy = rays[8 * (size_t)S];
    state = a.state_in[slot];
  } else {
    // ---- init: first IC interaction from air.  A ray that dies here keeps
    // its launch position and fields and zero gaps.
    float pa[4], pb[4];
    jones(cp + INIT_JA, ter, tei, tmr, tmi, pa);
    jones(cp + INIT_JB, ter, tei, tmr, tmi, pb);
    const float inv_cos0 = 1.0f / cp[INIT_COS0];
    const float eff_a0 = power4(pa) * cp[INIT_SA] * inv_cos0;
    const float eff_ab0 = eff_a0 + power4(pb) * cp[INIT_SB] * inv_cos0;
    rng = xorshift32(rng);
    const float u = draw24(rng);
    const bool br_a = u <= eff_a0;
    const bool br_b = !br_a && u <= eff_ab0;
    const int d = br_a ? 0 : 4;  // direction 0 (accept A) or 2 (accept B)
    const float x1 = x + cp[GAPS + d], y1 = y + cp[GAPS + d + 1];
    const bool icin = in_ic(g, x1, y1);
    state = br_a ? (icin ? 0 : 2) : ((br_b && icin) ? 1 : 6);
    cos_th = br_a ? cp[IC_SA] : cp[IC_SB];
    gx = 0.0f;
    gy = 0.0f;
    if (state < 6) {
      const float* pn = br_a ? pa : pb;
      const float inv = rsqrt_ieee(power4(pn));
      const float tr = pn[2] * inv, ti = pn[3] * inv;
      x = x1;
      y = y1;
      ter = pn[0] * inv;
      tei = pn[1] * inv;
      tmr = cp[TIR_PH + d] * tr - cp[TIR_PH + d + 1] * ti;
      tmi = cp[TIR_PH + d] * ti + cp[TIR_PH + d + 1] * tr;
      gx = cp[GAPS + d];
      gy = cp[GAPS + d + 1];
    }
  }

  int dep = -1;
  int it = 0;  // iterations this ray began alive
  while (state < 6 && it < a.max_bounces) {
    ++it;
    if (!region(g, G_R1, a.n_r1, x, y)) {
      state = 6;
      break;
    }
    const bool grp_ic = state <= 1;
    const bool grp_fc = state == 2 || state == 3;
    const bool grp_oc = state >= 4;
    const int bit = state & 1;
    const float* ja;
    const float* jc = zeros;
    float s_a, s_b;
    bool interact;
    if (grp_ic) {
      ja = cp + IC_BLK + 16 * bit;
      s_a = cp[IC_SA];
      s_b = cp[IC_SB];
      interact = true;
    } else if (grp_fc) {
      interact = region(g, G_HULL, a.n_hull, x, y);
      const float yrot = g[G_FC_ROT] * x + g[G_FC_ROT + 1] * y;
      const int k = bin_index((g[G_FC_TOP] - yrot) * g[G_FC_INVW],
                              a.num_fc - 1);
      const int base = FC_BLK + FC_STRIDE * k;
      ja = cp + base + 16 * bit;
      s_a = cp[base + 32];
      s_b = cp[base + 33];
    } else {
      interact = x >= g[G_OC_BT] && x <= g[G_OC_BT + 1] &&
                 y >= g[G_OC_BT + 2] && y <= g[G_OC_BT + 3];
      const float yr = g[G_OC_ROT] * x + g[G_OC_ROT + 1] * y;
      const int k = bin_index((g[G_OC_TOP] - yr) * g[G_OC_INVW],
                              a.num_oc - 1);
      const int base = OC_BLK + OC_STRIDE * k;
      ja = cp + base + 24 * bit;
      jc = ja + 16;
      s_a = cp[base + 48];
      s_b = cp[base + 49];
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
      rng = xorshift32(rng);  // the stream advances only on an interaction
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
        gx = cp[GAPS + 2 * dir];  // an accepted branch moves by its new gap
        gy = cp[GAPS + 1 + 2 * dir];
        x = x + gx;
        y = y + gy;
        const bool icin = in_ic(g, x, y);
        state = br_a ? (grp_oc ? 4 : (grp_fc ? 2 : (icin ? 0 : 2)))
                     : (grp_oc ? 5 : (grp_fc ? 3 : (icin ? 1 : 6)));
      } else {
        if (br_c && x >= cp[EBT] && x <= cp[EBT + 1] && y >= cp[EBT + 2] &&
            y <= cp[EBT + 3]) {
          const int ix = bin_index((x - cp[EBR]) * cp[EBS], a.nx - 1);
          const int iy = bin_index((y - cp[EBR + 2]) * cp[EBS + 1], a.ny - 1);
          dep = iy * a.nx + ix;
        }
        state = 6;  // out-coupled (inside the eyebox or not) or absorbed
      }
    } else {
      // misses: TIR hop by the carried gap, FC fold-out to the OC, OC exit
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

  float* out = a.rays_out + (size_t)cell * 9 * S + i;
  out[0] = x;
  out[S] = y;
  out[2 * (size_t)S] = ter;
  out[3 * (size_t)S] = tei;
  out[4 * (size_t)S] = tmr;
  out[5 * (size_t)S] = tmi;
  out[6 * (size_t)S] = cos_th;
  out[7 * (size_t)S] = gx;
  out[8 * (size_t)S] = gy;
  a.dep[slot] = dep;
  a.state_out[slot] = state;
  a.rng_out[slot] = rng;

  // every thread of the block reaches this point (no early return above)
  const int warp_bounces = __reduce_add_sync(0xffffffffu, it);
  const int warp_iters = __reduce_max_sync(0xffffffffu, it);
  if ((tid & 31) == 0 && warp_bounces) {
    atomicAdd(&a.nb[2 * cell], warp_bounces);
    atomicMax(&a.nb[2 * cell + 1], warp_iters);
  }
}

}  // namespace

extern "C" int cell_trace_launch(
    const void* cell_params, const void* geom_row, const void* rays_in,
    const void* state_in, const void* rng_in, void* dep, void* nb,
    void* rays_out, void* state_out, void* rng_out, int C, int S, int num_fc,
    int num_oc, int n_hull, int n_r1, int n_r2, int ny, int nx,
    int max_bounces, int threads, void* stream) {
  if (C <= 0) return 0;
  if (threads <= 0 || threads > 128 || threads % 32 != 0 || S <= 0 ||
      S % threads != 0 || (long long)C * (S / threads) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.cell_params = static_cast<const float*>(cell_params);
  a.geom_row = static_cast<const float*>(geom_row);
  a.rays_in = static_cast<const float*>(rays_in);
  a.state_in = static_cast<const int*>(state_in);
  a.rng_in = static_cast<const uint32_t*>(rng_in);
  a.dep = static_cast<int*>(dep);
  a.nb = static_cast<int*>(nb);
  a.rays_out = static_cast<float*>(rays_out);
  a.state_out = static_cast<int*>(state_out);
  a.rng_out = static_cast<uint32_t*>(rng_out);
  a.S = S;
  a.num_fc = num_fc;
  a.num_oc = num_oc;
  a.n_hull = n_hull;
  a.n_r1 = n_r1;
  a.n_r2 = n_r2;
  a.ny = ny;
  a.nx = nx;
  a.max_bounces = max_bounces;
  const unsigned grid = (unsigned)C * (unsigned)(S / threads);
  cell_trace_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* cell_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
