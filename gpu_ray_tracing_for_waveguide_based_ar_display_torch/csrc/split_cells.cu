// The exact per-cell splitting engine for NVIDIA Hopper (sm_90a): one launch
// traces every wavefront of a chunk of (lambda, FoV) cells to the end.
//
// Replaces no Pallas kernel.  The JAX package runs its per-cell engine
// (engine/splitting.py::make_splitting_cells_fn, fast=False) as jnp under a
// jax.lax.while_loop on its device; the port's plain PyTorch version
// (engine/splitting.py::split_cells_reference) runs that loop eagerly from
// the host: about 300 operations and two reads of the device per step.
// This kernel runs the whole loop inside one block per cell, so a chunk is
// one launch and no step reads the device from the host.
//
// Per cell, every step takes each slot of the wavefront to its two children
// (the branch A and B transports of split_step), its deposit and its pruned
// weight, with the plain version's float32 operations in its order (no
// contraction: -fmad=false; 1 / sqrt as __fdiv_rn(1, __fsqrt_rn(v)); every
// comparison against a float32 constant, as torch compares a float32 tensor
// with a Python scalar).  The next wavefront is the live A children in slot
// order, then the live B children in slot order, cut to K slots (the rest
// goes to the truncated ledger, and the peak counts the live children
// before the cut): the plain version's per-row cumsum compaction.
//
// Design.  One block of 512 threads per cell, the step loop inside the
// block, __syncthreads between phases; a cell's results do not depend on
// the other cells of its launch.  The wavefront lives in device memory,
// double-buffered, with a side buffer for the B children (11 fields of K
// slots each, 132 * K bytes a buffer).  A step walks its slots in chunks of
// 512: each thread computes one slot; a block scan of the (A live, B live,
// deposits) flags gives each child its place, so A children go straight to
// the next buffer and B children to the side buffer, which is copied in
// behind the A children after the sweep.  The cell's (ny, nx) tile lives in
// shared memory; a chunk's deposits are sorted by (bin, slot) in a bitonic
// sort over the next power of two of their count, and the first deposit of
// each bin adds the bin's run in slot order: every bin receives its adds in
// the plain version's order (the deposits of earlier chunks and steps
// first), with no float atomics.  The pruned and truncated weights are
// summed per step in float64 in a fixed order and rounded once, then added
// to the float32 ledgers as the plain version adds them.
//
// What bounds it on an H100: the bytes of the wavefront (each stepped slot
// read once, 44 B, and written once as a child, 44 B) over the sum of the
// widths of the steps, and each cell's records (staged in shared memory
// once) and tile once; its float32 work is about 200 operations a slot.
// Two blocks fit an SM (64 registers a thread, about 50 KB of shared
// memory), so a 256-cell chunk is one wave on 132 SMs; the threads of a
// narrow wavefront idle: a simple kernel first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLOT_BITS = 9;          // a slot's index within its chunk

struct Args {
  const float* rec;      // (26, C * R2) component-major
  const float* cell;     // (26, C)
  const float* dirs;     // (6, C * 4)
  const float* geom;     // NG scalars, then the four half-plane packs
  const uint8_t* grid;   // (grid_n, grid_n) region codes
  const float* seeds;    // (6, P), or (6, C, P) with per_cell_seeds
  float* buf;            // (C, 3, NF, K) wavefront scratch
  float* tiles;          // (C, ny * nx)
  float* trunc;          // (C,)
  float* pruned;         // (C,)
  int* peak;             // (C,)
  int* steps;            // (C,)
  long long* work;       // (C,) slots stepped, summed over the steps
  int C, P, K, R2, num_fc, num_oc, ny, nx, max_steps, per_cell_seeds, circle;
  int grid_n, e_ic, e_r1, e_r2, e_hull;
  float thr;
};

// a block-wide sum of one double per thread in a fixed order
__device__ double block_sum(double v, double* s_red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  double t = 0.0;
  for (int k = 0; k < WARPS; ++k) t += s_red[k];
  return t;
}

__global__ void __launch_bounds__(THREADS)
split_cells_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_wsum[WARPS];
  __shared__ double s_red[WARPS];
  const int c = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = a.ny * a.nx;
  const int ng = NG + 3 * (a.e_ic + a.e_r1 + a.e_r2 + a.e_hull);

  float* s_tile = smem;
  float* s_rec = s_tile + nb;
  float* s_cell = s_rec + REC_W * a.R2;
  float* s_dirs = s_cell + CELL_W;
  float* s_geom = s_dirs + 4 * DIR_W;
  unsigned* s_key = reinterpret_cast<unsigned*>(s_geom + ng);
  float* s_dw = reinterpret_cast<float*>(s_key + THREADS);

  for (int k = tid; k < nb; k += THREADS) s_tile[k] = 0.0f;
  for (int k = tid; k < REC_W * a.R2; k += THREADS) {
    const int comp = k / a.R2, key = k - comp * a.R2;
    s_rec[key * REC_W + comp] =
        a.rec[(size_t)comp * a.C * a.R2 + (size_t)c * a.R2 + key];
  }
  if (tid < CELL_W) s_cell[tid] = a.cell[(size_t)tid * a.C + c];
  if (tid < 4 * DIR_W) {
    const int dir = tid / DIR_W, comp = tid - dir * DIR_W;
    s_dirs[tid] = a.dirs[(size_t)comp * a.C * 4 + (size_t)c * 4 + dir];
  }
  for (int k = tid; k < ng; k += THREADS) s_geom[k] = a.geom[k];
  __syncthreads();

  Cell cc;
  cc.rec = s_rec;
  cc.cell = s_cell;
  cc.dirs = s_dirs;
  cc.g = s_geom;
  cc.ic_hp = s_geom + NG;
  cc.r1_hp = cc.ic_hp + 3 * a.e_ic;
  cc.r2_hp = cc.r1_hp + 3 * a.e_r1;
  cc.hull_hp = cc.r2_hp + 3 * a.e_r2;
  cc.grid = a.grid;
  cc.e_ic = a.e_ic;
  cc.e_r1 = a.e_r1;
  cc.e_r2 = a.e_r2;
  cc.e_hull = a.e_hull;
  cc.grid_n = a.grid_n;
  cc.num_fc = a.num_fc;
  cc.num_oc = a.num_oc;
  cc.ny = a.ny;
  cc.nx = a.nx;
  cc.circle = a.circle != 0;
  cc.thr = a.thr;

  const int K = a.K;
  float* base = a.buf + (size_t)c * 3 * NF * K;
  float* side = base + (size_t)2 * NF * K;
  const float* seeds = a.seeds + (a.per_cell_seeds ? (size_t)c * a.P : 0);
  const size_t seed_stride = (size_t)a.P * (a.per_cell_seeds ? a.C : 1);

  float pruned = 0.0f, trunc = 0.0f;
  int peak = 0, it = 0;
  long long work = 0;
  int n = a.P;       // the width being swept (the seeds, then each step's)
  int cur = -1;      // the buffer being swept (-1: the seeds)
  while (true) {
    float* next = base + (size_t)(cur == 0 ? 1 : 0) * NF * K;
    const float* src = cur < 0 ? nullptr : base + (size_t)cur * NF * K;
    double pr_a = 0.0, pr_b = 0.0, drop = 0.0;
    int run_a = 0, run_b = 0;
    for (int c0 = 0; c0 < n; c0 += THREADS) {
      const int i = c0 + tid;
      Ray ca, cb;
      int dbin = -1;
      float dw = 0.0f;
      bool la = false, lb = false;
      if (i < n) {
        float pa, pb;
        if (cur < 0) {
          float s[6];
          for (int f = 0; f < 6; ++f) s[f] = seeds[f * seed_stride + i];
          init_children(cc, s, ca, cb, pa, pb);
        } else {
          step_children(cc, load_ray(src, K, i), ca, cb, dbin, dw, pa, pb);
        }
        pr_a += pa;
        pr_b += pb;
        la = ca.st < DEAD;
        lb = cb.st < DEAD;
      }
      const bool ld = dbin >= 0;
      // block scan of the packed flags (10 bits each: at most 512 a chunk)
      const int v = (int)la | ((int)lb << 10) | ((int)ld << 20);
      int incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane == 31) s_wsum[warp] = incl;
      __syncthreads();
      int off = 0, tot = 0;
      for (int k = 0; k < WARPS; ++k) {
        const int s = s_wsum[k];
        if (k < warp) off += s;
        tot += s;
      }
      const int ex = off + incl - v;
      const int ex_a = ex & 1023, ex_b = (ex >> 10) & 1023, ex_d = ex >> 20;
      const int tot_a = tot & 1023, tot_b = (tot >> 10) & 1023;
      const int tot_d = tot >> 20;
      if (la) {
        const int p = run_a + ex_a;
        if (p < K) store_ray(next, K, p, ca);
        else drop += ca.w;
      }
      if (lb) {
        const int p = run_b + ex_b;
        if (p < K) store_ray(side, K, p, cb);
        else drop += cb.w;
      }
      if (tot_d > 0) {
        // the chunk's deposits by (bin, slot), then each bin's run in order
        if (ld) {
          s_key[ex_d] = ((unsigned)dbin << SLOT_BITS) | (unsigned)tid;
          s_dw[tid] = dw;
        }
        int p2 = 1;
        while (p2 < tot_d) p2 <<= 1;
        if (tid >= tot_d && tid < p2) s_key[tid] = 0xFFFFFFFFu;
        __syncthreads();
        for (int k = 2; k <= p2; k <<= 1) {
          for (int j = k >> 1; j > 0; j >>= 1) {
            const int ixj = tid ^ j;
            if (tid < p2 && ixj > tid) {
              const unsigned u = s_key[tid], w = s_key[ixj];
              if ((u > w) == ((tid & k) == 0)) {
                s_key[tid] = w;
                s_key[ixj] = u;
              }
            }
            __syncthreads();
          }
        }
        if (tid < tot_d) {
          const unsigned key = s_key[tid];
          const unsigned b = key >> SLOT_BITS;
          if (tid == 0 || (s_key[tid - 1] >> SLOT_BITS) != b) {
            float acc = s_tile[b];
            for (int u = tid; u < tot_d && (s_key[u] >> SLOT_BITS) == b; ++u)
              acc = acc + s_dw[s_key[u] & ((1u << SLOT_BITS) - 1)];
            s_tile[b] = acc;
          }
        }
      }
      run_a += tot_a;
      run_b += tot_b;
      __syncthreads();
    }
    if (cur >= 0) work += n;
    // the B children behind the A children, cut to K slots
    const int live = run_a + run_b;
    const int keep_b = max(0, min(run_b, K - run_a));
    for (int k = tid; k < keep_b; k += THREADS)
      store_ray(next, K, run_a + k, load_ray(side, K, k));
    for (int k = keep_b + tid; k < min(run_b, K); k += THREADS)
      drop += side[F_W * K + k];
    const float fa = (float)block_sum(pr_a, s_red);
    const float fb = (float)block_sum(pr_b, s_red);
    const float fd = (float)block_sum(drop, s_red);
    pruned = pruned + (fa + fb);
    trunc = trunc + fd;
    peak = max(peak, live);
    if (cur >= 0) ++it;
    cur = cur == 0 ? 1 : 0;
    n = min(K, live);
    // the copy into `next` ends before it is swept
    __syncthreads();
    if (n == 0 || it >= a.max_steps) break;
  }

  float* tile = a.tiles + (size_t)c * nb;
  for (int k = tid; k < nb; k += THREADS) tile[k] = s_tile[k];
  if (tid == 0) {
    a.trunc[c] = trunc;
    a.pruned[c] = pruned;
    a.peak[c] = peak;
    a.steps[c] = it;
    a.work[c] = work;
  }
}

size_t shared_bytes(int ny, int nx, int R2, int e_total) {
  return sizeof(float) * ((size_t)ny * nx + REC_W * R2 + CELL_W + 4 * DIR_W
                          + NG + 3 * e_total)
         + (sizeof(unsigned) + sizeof(float)) * THREADS;
}

}  // namespace

// Launch on `stream`: C cells' wavefront traces (layouts as in Args).
// Returns a cudaError_t code (0: launched).
extern "C" int split_cells_launch(
    const void* rec, const void* cell, const void* dirs, const void* geom,
    const void* grid, const void* seeds, void* buf, void* tiles, void* trunc,
    void* pruned, void* peak, void* steps, void* work, int C, int P, int K,
    int R2, int num_fc, int num_oc, int ny, int nx, int max_steps,
    int per_cell_seeds, int circle, int grid_n, int e_ic, int e_r1, int e_r2,
    int e_hull, float thr, void* stream) {
  if (C <= 0) return 0;
  if (P < 0 || 2 * P > K || K <= 0 || R2 != 2 * (1 + num_fc + num_oc) ||
      num_fc < 1 || num_oc < 1 || ny < 1 || nx < 1 ||
      (long long)ny * nx >= (1LL << (32 - SLOT_BITS)) || grid_n < 1 ||
      e_ic < 0 || e_r1 < 0 || e_r2 < 0 || e_hull < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(ny, nx, R2, e_ic + e_r1 + e_r2 + e_hull);
  cudaError_t err = cudaFuncSetAttribute(
      split_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.rec = static_cast<const float*>(rec);
  a.cell = static_cast<const float*>(cell);
  a.dirs = static_cast<const float*>(dirs);
  a.geom = static_cast<const float*>(geom);
  a.grid = static_cast<const uint8_t*>(grid);
  a.seeds = static_cast<const float*>(seeds);
  a.buf = static_cast<float*>(buf);
  a.tiles = static_cast<float*>(tiles);
  a.trunc = static_cast<float*>(trunc);
  a.pruned = static_cast<float*>(pruned);
  a.peak = static_cast<int*>(peak);
  a.steps = static_cast<int*>(steps);
  a.work = static_cast<long long*>(work);
  a.C = C;
  a.P = P;
  a.K = K;
  a.R2 = R2;
  a.num_fc = num_fc;
  a.num_oc = num_oc;
  a.ny = ny;
  a.nx = nx;
  a.max_steps = max_steps;
  a.per_cell_seeds = per_cell_seeds;
  a.circle = circle;
  a.grid_n = grid_n;
  a.e_ic = e_ic;
  a.e_r1 = e_r1;
  a.e_r2 = e_r2;
  a.e_hull = e_hull;
  a.thr = thr;
  split_cells_kernel<<<C, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* split_cells_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
