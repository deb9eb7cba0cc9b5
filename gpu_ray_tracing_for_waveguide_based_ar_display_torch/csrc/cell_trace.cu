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
// Design: lanes that refill from a per-cell queue.  A ray's outcome depends
// only on its own fields, state and RNG stream, so the order in which lanes
// take rays changes no output.  The grid is C runs of `blocks_per_cell`
// blocks; each block owns a contiguous range of one cell's rays with a claim
// counter in shared memory, and copies its cell row (704 floats) and the
// geometry row (320 floats) into shared memory.  A warp claims rays for all
// its lanes that need one in one step (ballot, one shared atomicAdd of the
// popcount by the leader, a shuffle of the base, each lane adds its rank);
// a lane runs the full-mode init or loads the resume state of the ray it
// takes, steps the bounce body once per round while its ray lives, and when
// the ray dies or has run `max_bounces` iterations writes that ray's outputs
// at the ray's own index and claims again.  The warp loops while any lane
// holds a ray, so a lane no longer idles until the warp's slowest ray ends:
// it idles only once its block's range is spent.  Rays that arrive dead
// (padding in full mode, `state_in >= 6` in resume mode) are written with
// dep = -1 and zero iterations.  FC / OC strip records are read by index and
// edge loops stop at the region's real edge count.  nb[c] = [bounces,
// iterations]: each lane sums the iterations its rays began alive and keeps
// the largest; after the loop a warp reduces them and adds once (integer
// atomics: the sum is independent of order); iterations is the largest such
// count of the cell.  The caller zeroes nb.
// What bounds it: per-lane divergent ALU work (rays of the FC and OC groups
// share warps), and, once a block's range is spent, its slowest rays; it
// reads every input once and writes every output once, though lanes that
// claim at different times touch partly used sectors.

#include "trace_common.cuh"

namespace {

constexpr int MAX_THREADS = 128;  // the widest block (the wrapper's rule)
constexpr unsigned FULL = 0xffffffffu;

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
  int S, num_fc, num_oc, n_hull, n_r1, n_r2, ny, nx, max_bounces,
      blocks_per_cell;
};

__global__ void __launch_bounds__(MAX_THREADS)
    cell_trace_kernel(Args a) {
  __shared__ float cp[PC + ZPAD];
  __shared__ float g[PG];
  __shared__ int s_next;  // the next unclaimed ray of the block's range
  const int S = a.S;
  const int bpc = a.blocks_per_cell;
  const int cell = blockIdx.x / bpc;
  const int part = blockIdx.x % bpc;
  const int hi = (int)((long long)S * (part + 1) / bpc);
  const int tid = threadIdx.x;
  const unsigned lane = tid & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const bool resume = a.state_in != nullptr;
  const int nf = resume ? 9 : 6;
  const float* crow = a.cell_params + (size_t)cell * PC;
  for (int j = tid; j < PC + ZPAD; j += blockDim.x)
    cp[j] = j < PC ? crow[j] : 0.0f;
  for (int j = tid; j < PG; j += blockDim.x) g[j] = a.geom_row[j];
  if (tid == 0) s_next = (int)((long long)S * part / bpc);
  const float* zeros = cp + PC;
  __syncthreads();

  const float* rays_cell = a.rays_in + (size_t)cell * nf * S;
  float* out_cell = a.rays_out + (size_t)cell * 9 * S;
  const size_t slot0 = (size_t)cell * S;

  int i = -1;         // the lane's ray in the cell, or -1
  bool more = true;   // the block's range may still hold a ray for the lane
  float x = 0.0f, y = 0.0f, ter = 0.0f, tei = 0.0f, tmr = 0.0f, tmi = 0.0f;
  float cos_th = 0.0f, gx = 0.0f, gy = 0.0f;
  int state = 6, dep = -1, it = 0;
  uint32_t rng = 0;
  int sum_it = 0, max_it = 0;  // over the rays this lane traced

  while (true) {
    // hand in an ended ray and take the next, until every lane holds a live
    // ray or its block's range is spent
    while (true) {
      if (i >= 0 && !(state < 6 && it < a.max_bounces)) {
        float* out = out_cell + i;
        out[0] = x;
        out[S] = y;
        out[2 * (size_t)S] = ter;
        out[3 * (size_t)S] = tei;
        out[4 * (size_t)S] = tmr;
        out[5 * (size_t)S] = tmi;
        out[6 * (size_t)S] = cos_th;
        out[7 * (size_t)S] = gx;
        out[8 * (size_t)S] = gy;
        a.dep[slot0 + i] = dep;
        a.state_out[slot0 + i] = state;
        a.rng_out[slot0 + i] = rng;
        sum_it += it;
        max_it = max(max_it, it);
        i = -1;
      }
      const bool need = i < 0 && more;
      const unsigned m = __ballot_sync(FULL, need);
      if (m == 0) break;
      const int leader = __ffs(m) - 1;
      int base = 0;
      if ((int)lane == leader) base = atomicAdd(&s_next, __popc(m));
      base = __shfl_sync(FULL, base, leader);
      const int r = base + __popc(m & lanes_below);
      if (need && r >= hi) more = false;
      if (!need || r >= hi) continue;
      i = r;
      const float* rays = rays_cell + i;
      x = rays[0];
      y = rays[S];
      ter = rays[2 * (size_t)S];
      tei = rays[3 * (size_t)S];
      tmr = rays[4 * (size_t)S];
      tmi = rays[5 * (size_t)S];
      rng = a.rng_in[slot0 + i];
      dep = -1;
      it = 0;
      if (resume) {
        cos_th = rays[6 * (size_t)S];
        gx = rays[7 * (size_t)S];
        gy = rays[8 * (size_t)S];
        state = a.state_in[slot0 + i];
      } else {
        // ---- init: first IC interaction from air.  A ray that dies here
        // keeps its launch position and fields and zero gaps.
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
    }
    if (!__any_sync(FULL, i >= 0)) break;
    if (i < 0) continue;  // this lane's range is spent; its warp's is not

    // ---- one iteration of the lane's live ray
    ++it;
    if (!region(g, G_R1, a.n_r1, x, y)) {
      state = 6;
      continue;
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

  // every lane of the warp leaves the loop together (the exit is a warp vote)
  const int warp_bounces = __reduce_add_sync(FULL, sum_it);
  const int warp_iters = __reduce_max_sync(FULL, max_it);
  if (lane == 0 && warp_bounces) {
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
    int max_bounces, int threads, int blocks_per_cell, void* stream) {
  if (C <= 0) return 0;
  if (threads <= 0 || threads > MAX_THREADS || threads % 32 != 0 || S <= 0 ||
      blocks_per_cell <= 0 || blocks_per_cell > S ||
      (long long)C * blocks_per_cell > 2147483647LL)
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
  a.blocks_per_cell = blocks_per_cell;
  const unsigned grid = (unsigned)C * (unsigned)blocks_per_cell;
  cell_trace_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// What the card makes of the kernel at `threads` threads per block:
// out = [resident blocks per SM, registers, local bytes per thread, static
// shared bytes].
extern "C" int cell_trace_occupancy(int threads, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, cell_trace_kernel);
  if (err != cudaSuccess) return (int)err;
  out[1] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)attr.sharedSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], cell_trace_kernel, threads, 0);
}

extern "C" const char* cell_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
