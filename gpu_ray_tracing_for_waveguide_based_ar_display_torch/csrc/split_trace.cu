// The global splitting engine for NVIDIA Hopper (sm_90a), forward and
// backward: the differentiable trace that `optimize` runs and
// Simulator(engine="splitting", splitting_percell=False) traces with.
//
// Replaces no Pallas kernel.  The JAX package runs this engine
// (engine/splitting.py::make_splitting_trace_fn) as jnp under a
// jax.lax.scan of fixed_steps steps (a lax.while_loop with its stop test),
// compacted by jnp.argsort, and differentiates it with jax.value_and_grad.
// The port's plain versions (engine/splitting.py::split_trace_reference,
// ::split_trace_backward_reference) run the step loop eagerly from the host
// (about 420 operations and a read of the device a step) and its adjoint as
// an explicit reverse sweep over a tape.  These kernels run both with no
// host read in a fixed_steps trace; a stop-tested trace reads the width
// once every 8 steps.
//
// Forward, a step (a few launches on one stream, the live width read from
// device memory by every launch): one thread per slot takes the slot to its
// two children, its deposit(s) and its pruned weights with the plain
// version's float32 operations in its order (the step transport of
// split_common.cuh, shared with split_cells.cu); the children (A of slot s
// at s, B at width + s) are sorted by a stable LSD radix sort on their
// weight, heaviest first (key ~bits(w), dead children last), and the first
// min(K, live) are gathered into the next wavefront with their provenance;
// the rest of the live ones go to the truncated ledger.  The step's deposits
// ((corner, slot) order: one round per corner in soft binning) are sorted
// by bin with the same sort, and the first deposit of each bin adds the
// bin's run in that order: every bin adds its deposits one by one in the
// plain version's order, with no float atomics.  The ledgers are summed per
// step in float64 in a fixed order by one block and added in float32.
//
// Backward, a step from the last to the first, then the launch rays: one
// thread per slot of the step's tape row reads its children's adjoints
// (written by the step after it at the children's provenance, zeroed as
// read), recomputes the step's decisions and values, writes its own adjoint
// at its provenance, and stages its table contributions (its record, its
// cell's out-coupling scale and deposit rectangle, its three direction
// rows); the contributions are sorted by table entry (stable, so in list
// order: slots in order, direction rows A, B, then the hops) and the first
// of each entry's run adds the run in order.  The arithmetic is the plain
// backward's, so the two agree bit for bit; two runs give identical bits.
//
// What bounds it on an H100: the bytes of the wavefront and its tape (each
// stepped slot read once and written once as a child, 13 words a kept
// slot), the sort passes over the children (4 passes of 8 bits, 8 B a key
// and index, read and written), the deposits and, backward, the table
// contributions (about 60 words a slot); its float32 work is about 200
// operations a slot forward and 600 backward.  At `optimize`'s widths
// (thousands of slots) a step is a few microseconds of work in about 25
// launches forward and 8 backward: launch latency bounds it.  A simple
// kernel first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

namespace {

constexpr int THREADS = 256;          // one slot (or child, or item) a thread
constexpr int RED_THREADS = 1024;     // the ledger's block
constexpr int NT = 13;                // tape fields: the NF, cid, src
constexpr int T_CID = 11, T_SRC = 12;
constexpr int NCH = 12;               // children buffer fields: NF, cid
constexpr int NADJ = 10;              // a slot's adjoint
enum { A_X, A_Y, A_TER, A_TEI, A_TMR, A_TMI, A_COS, A_GX, A_GY, A_W };
constexpr int RADIX = 256;
constexpr int SORT_THREADS = 256;
constexpr int SORT_ITEMS = 4;
constexpr int TILE = SORT_THREADS * SORT_ITEMS;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr unsigned NO_KEY = 0xFFFFFFFFu;

// the int parameters (engine/splitting.py::TRACE_PARAMS)
enum { P_R, P_K, P_E, P_C, P_R2, P_NUM_FC, P_NUM_OC, P_NY, P_NX, P_M, P_N,
       P_HIST, P_SOFT, P_CIRCLE, P_GRID_N, P_E_IC, P_E_R1, P_E_R2, P_E_HULL,
       P_T0, P_NSTEPS, P_RING, P_INIT, NPARAM };
// device counters (engine/splitting.py::_NCNT, _CNT_STEPS)
enum { CNT_ITEMS, CNT_LIVE, CNT_DEPS, CNT_USED, CNT_STEPS };

struct Args {
  const float* rec;      // (E, 26) entry-major: cell g's key k at g * R2 + k
  const float* cell;     // (C, 26)
  const float* dirs;     // (C * 4, 6)
  const float* geom;     // NG scalars, then the four half-plane packs
  const uint8_t* grid;   // (grid_n, grid_n) region codes
  const float* rays;     // (6, R) launch rays: x, y, ter, tei, tmr, tmi
  const int* cid0;       // (R,) their table cells
  int R, K, CH, E, C, R2, num_fc, num_oc, ny, nx, M, N, hist, soft, circle;
  int grid_n, e_ic, e_r1, e_r2, e_hull;
  float thr;
};

Args make_args(const int* p, float thr, const void* rec, const void* cell,
               const void* dirs, const void* geom, const void* grid,
               const void* rays, const void* cid) {
  Args a;
  a.rec = static_cast<const float*>(rec);
  a.cell = static_cast<const float*>(cell);
  a.dirs = static_cast<const float*>(dirs);
  a.geom = static_cast<const float*>(geom);
  a.grid = static_cast<const uint8_t*>(grid);
  a.rays = static_cast<const float*>(rays);
  a.cid0 = static_cast<const int*>(cid);
  a.R = p[P_R];
  a.K = p[P_K];
  a.CH = 2 * (p[P_R] > p[P_K] ? p[P_R] : p[P_K]);
  a.E = p[P_E];
  a.C = p[P_C];
  a.R2 = p[P_R2];
  a.num_fc = p[P_NUM_FC];
  a.num_oc = p[P_NUM_OC];
  a.ny = p[P_NY];
  a.nx = p[P_NX];
  a.M = p[P_M];
  a.N = p[P_N];
  a.hist = p[P_HIST];
  a.soft = p[P_SOFT];
  a.circle = p[P_CIRCLE];
  a.grid_n = p[P_GRID_N];
  a.e_ic = p[P_E_IC];
  a.e_r1 = p[P_E_R1];
  a.e_r2 = p[P_E_R2];
  a.e_hull = p[P_E_HULL];
  a.thr = thr;
  return a;
}

// cell g's tables and the geometry, as the step transport reads them
__device__ __forceinline__ Cell cell_view(const Args& a, int g) {
  Cell c;
  c.rec = a.rec + (size_t)g * a.R2 * REC_W;
  c.cell = a.cell + (size_t)g * CELL_W;
  c.dirs = a.dirs + (size_t)g * 4 * DIR_W;
  c.g = a.geom;
  c.ic_hp = a.geom + NG;
  c.r1_hp = c.ic_hp + 3 * a.e_ic;
  c.r2_hp = c.r1_hp + 3 * a.e_r1;
  c.hull_hp = c.r2_hp + 3 * a.e_r2;
  c.grid = a.grid;
  c.e_ic = a.e_ic;
  c.e_r1 = a.e_r1;
  c.e_r2 = a.e_r2;
  c.e_hull = a.e_hull;
  c.grid_n = a.grid_n;
  c.circle = a.circle != 0;
  c.num_fc = a.num_fc;
  c.num_oc = a.num_oc;
  c.ny = a.ny;
  c.nx = a.nx;
  c.thr = a.thr;
  return c;
}

// the first bin of cell cid's (ny, nx) map in the (L, N, M, ny, nx) one
__device__ __forceinline__ int grid_base(const Args& a, int cid) {
  const int nmn = a.M * a.N;
  const int mn = cid % nmn;
  return ((cid / nmn * a.N + mn % a.N) * a.M + mn / a.N) * (a.ny * a.nx);
}

// the bilinear deposit's geometry at (x, y) in rectangle e
struct Soft {
  bool in_quad;
  float dxb, dyb, qx, qy, pu, pv, fx, fy, ax, ay;
  int ix0, iy0;
};

__device__ void soft_bins(const float* e, float x, float y, int ny, int nx,
                          Soft& s) {
  s.in_quad = x >= e[0] - EDGE_TOL && x <= e[1] + EDGE_TOL
              && y >= e[2] - EDGE_TOL && y <= e[3] + EDGE_TOL;
  s.dxb = __fdiv_rn(e[1] - e[0], (float)nx);
  s.dyb = __fdiv_rn(e[3] - e[2], (float)ny);
  s.qx = __fdiv_rn(x - e[0], s.dxb);
  s.qy = __fdiv_rn(y - e[2], s.dyb);
  s.pu = s.qx - 0.5f;
  s.pv = s.qy - 0.5f;
  const float u = fminf(fmaxf(s.pu, 0.0f), (float)(nx - 1));
  const float v = fminf(fmaxf(s.pv, 0.0f), (float)(ny - 1));
  s.ix0 = (int)fminf(fmaxf(floorf(u), 0.0f), (float)(nx - 2));
  s.iy0 = (int)fminf(fmaxf(floorf(v), 0.0f), (float)(ny - 2));
  s.fx = u - (float)s.ix0;
  s.fy = v - (float)s.iy0;
  s.ax = 1.0f - s.fx;
  s.ay = 1.0f - s.fy;
}

// corner k (0: (0, 0), 1: (1, 0), 2: (0, 1), 3: (1, 1)): weight and bin
__device__ __forceinline__ float soft_weight(const Soft& s, int k) {
  return k == 0 ? s.ax * s.ay : k == 1 ? s.fx * s.ay
                : k == 2 ? s.ax * s.fy : s.fx * s.fy;
}

__device__ __forceinline__ int soft_bin(const Soft& s, int k, int nx) {
  return (s.iy0 + (k >> 1)) * nx + s.ix0 + (k & 1);
}

// ---------------------------------------------------------------------------
// the stable LSD radix sort of (key, index) pairs, `count` of them on the
// device (at most the launch's grid), 8 bits a pass

__global__ void __launch_bounds__(SORT_THREADS)
radix_hist(const unsigned* keys, const int* count, int shift,
           unsigned* counts) {
  __shared__ unsigned s[RADIX];
  const int n = *count, nb = (n + TILE - 1) / TILE, b = blockIdx.x;
  if (b >= nb) return;
  for (int d = threadIdx.x; d < RADIX; d += SORT_THREADS) s[d] = 0u;
  __syncthreads();
  for (int k = 0; k < SORT_ITEMS; ++k) {
    const int i = b * TILE + k * SORT_THREADS + threadIdx.x;
    if (i < n) atomicAdd(&s[(keys[i] >> shift) & (RADIX - 1)], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += SORT_THREADS)
    counts[d * nb + b] = s[d];
}

// exclusive scan of the (digit, block) counts, digit-major, in one block
__global__ void __launch_bounds__(1024)
radix_scan(unsigned* counts, const int* count) {
  __shared__ unsigned s[1024];
  const int n = *count, nb = (n + TILE - 1) / TILE, m = RADIX * nb;
  const int per = (m + 1023) / 1024;
  const int lo = min(m, (int)threadIdx.x * per), hi = min(m, lo + per);
  unsigned sum = 0u;
  for (int k = lo; k < hi; ++k) sum += counts[k];
  s[threadIdx.x] = sum;
  __syncthreads();
  for (int o = 1; o < 1024; o <<= 1) {
    const unsigned v = threadIdx.x >= (unsigned)o ? s[threadIdx.x - o] : 0u;
    __syncthreads();
    s[threadIdx.x] += v;
    __syncthreads();
  }
  unsigned run = threadIdx.x ? s[threadIdx.x - 1] : 0u;
  for (int k = lo; k < hi; ++k) {
    const unsigned c = counts[k];
    counts[k] = run;
    run += c;
  }
}

// each item to its place: its digit's offset for the block, plus the items
// of that digit before it in the block (in item order: stable)
__global__ void __launch_bounds__(SORT_THREADS)
radix_scatter(const unsigned* kin, const int* vin, unsigned* kout, int* vout,
              const int* count, int shift, const unsigned* counts) {
  __shared__ unsigned s_base[RADIX];
  __shared__ unsigned s_wc[SORT_WARPS][RADIX];
  const int n = *count, nb = (n + TILE - 1) / TILE, b = blockIdx.x;
  if (b >= nb) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < RADIX; d += SORT_THREADS)
    s_base[d] = counts[d * nb + b];
  for (int k = 0; k < SORT_ITEMS; ++k) {
    const int i = b * TILE + k * SORT_THREADS + tid;
    const bool valid = i < n;
    const unsigned key = valid ? kin[i] : 0u;
    const int d = valid ? (int)((key >> shift) & (RADIX - 1)) : RADIX;
    for (int e = tid; e < SORT_WARPS * RADIX; e += SORT_THREADS)
      s_wc[e / RADIX][e % RADIX] = 0u;
    __syncthreads();
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    const unsigned rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0u) s_wc[warp][d] = __popc(peers);
    __syncthreads();
    if (tid < RADIX) {
      unsigned run = s_base[tid];
      for (int w = 0; w < SORT_WARPS; ++w) {
        const unsigned c = s_wc[w][tid];
        s_wc[w][tid] = run;
        run += c;
      }
      s_base[tid] = run;
    }
    __syncthreads();
    if (valid) {
      const unsigned pos = s_wc[warp][d] + rank;
      kout[pos] = key;
      vout[pos] = vin ? vin[i] : i;
    }
    __syncthreads();
  }
}

// the sort's buffers: keys and indices, two of each
struct SortBuf {
  unsigned* k[2];
  int* v[2];
  unsigned* counts;
};

// sorts the first *count (<= nmax) pairs of (s.k[0], item index) by their
// `bits` low key bits; returns the buffer that holds the result
int radix_sort(const SortBuf& s, const int* count, int nmax, int bits,
               cudaStream_t st, cudaError_t& err) {
  const int blocks = (nmax + TILE - 1) / TILE;
  const int passes = (bits + 7) / 8;
  err = cudaSuccess;
  if (blocks == 0) return 0;
  for (int p = 0; p < passes; ++p) {
    const int in = p & 1, out = in ^ 1;
    radix_hist<<<blocks, SORT_THREADS, 0, st>>>(s.k[in], count, 8 * p,
                                               s.counts);
    radix_scan<<<1, 1024, 0, st>>>(s.counts, count);
    radix_scatter<<<blocks, SORT_THREADS, 0, st>>>(
        s.k[in], p == 0 ? nullptr : s.v[in], s.k[out], s.v[out], count,
        8 * p, s.counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return 0;
  }
  return passes & 1;
}

int bit_length(unsigned v) {
  int b = 0;
  while (v) {
    ++b;
    v >>= 1;
  }
  return b;
}

// ---------------------------------------------------------------------------
// the forward

// a child into the children buffer (NCH fields of CH), with its sort key
__device__ __forceinline__ void put_child(const Args& a, float* ch,
                                          unsigned* keys, int j,
                                          const Ray& r, int g, int* cnt) {
  store_ray(ch, a.CH, j, r);
  ch[(size_t)T_CID * a.CH + j] = __int_as_float(g);
  const bool live = r.st < DEAD;
  // a live weight exceeds the threshold (>= 0): positive, so its bits order
  // it and ~bits sorts the heaviest first; no live key is NO_KEY
  keys[j] = live ? ~__float_as_uint(r.w) : NO_KEY;
  if (live) atomicAdd(&cnt[CNT_LIVE], 1);
}

__global__ void __launch_bounds__(THREADS)
init_kernel(const Args a, float* ch, unsigned* keys, float* pr, int* cnt) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) cnt[CNT_ITEMS] = 2 * a.R;
  if (i >= a.R) return;
  const int g = a.cid0[i];
  const Cell c = cell_view(a, g);
  float s[6];
  for (int f = 0; f < 6; ++f) s[f] = a.rays[(size_t)f * a.R + i];
  Ray ra, rb;
  float pa, pb;
  init_children(c, s, ra, rb, pa, pb);
  put_child(a, ch, keys, i, ra, g, cnt);
  put_child(a, ch, keys, a.R + i, rb, g, cnt);
  pr[i] = pa;
  pr[a.R + i] = pb;
}

// step t over tape row `row`: children, pruned weights and deposits
__global__ void __launch_bounds__(THREADS)
step_kernel(const Args a, const float* row, const int* widths, int t,
            float* ch, unsigned* keys, float* pr, unsigned* dkeys,
            float* dvals, int* cnt) {
  const int n = widths[t];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) {
    cnt[CNT_ITEMS] = 2 * n;
    cnt[CNT_DEPS] = (a.soft ? 4 : 1) * n;
  }
  if (i >= n) return;
  const Ray r = load_ray(row, a.K, i);
  const int g = __float_as_int(row[(size_t)T_CID * a.K + i]);
  const Cell c = cell_view(a, g);
  Ray ca, cb;
  int dbin;
  float dw, pa, pb;
  step_children(c, r, ca, cb, dbin, dw, pa, pb);
  put_child(a, ch, keys, i, ca, g, cnt);
  put_child(a, ch, keys, n + i, cb, g, cnt);
  pr[i] = pa;
  pr[n + i] = pb;
  const int base = grid_base(a, g);
  if (!a.soft) {
    const bool use = dbin >= 0;
    dkeys[i] = use ? (unsigned)(base + dbin) : (unsigned)a.hist;
    dvals[i] = dw;
    if (use) atomicAdd(&cnt[CNT_USED], 1);
    return;
  }
  // dw: the deposit weight inside the rectangle, else 0 (the soft mode's
  // where(in_quad, dep_w, 0))
  Soft s;
  soft_bins(c.cell + C_EBR, r.x, r.y, a.ny, a.nx, s);
  for (int k = 0; k < 4; ++k) {
    const float val = dw * soft_weight(s, k);
    const bool use = val != 0.0f;
    dkeys[k * n + i] = use ? (unsigned)(base + soft_bin(s, k, a.nx))
                           : (unsigned)a.hist;
    dvals[k * n + i] = val;
    if (use) atomicAdd(&cnt[CNT_USED], 1);
  }
}

// the sorted children: the first min(K, live) into tape row `out` with
// their provenance, the other live ones' weights to `drop`
__global__ void __launch_bounds__(THREADS)
compact_kernel(const Args a, const float* ch, const int* order, float* out,
               int* widths, int t1, float* drop, const int* cnt) {
  const int live = cnt[CNT_LIVE];
  const int width = min(a.K, live);
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j == 0) widths[t1] = width;
  if (j >= live) return;
  const int s = order[j];
  if (j < width) {
    for (int f = 0; f < NCH; ++f)
      out[(size_t)f * a.K + j] = ch[(size_t)f * a.CH + s];
    out[(size_t)T_SRC * a.K + j] = __int_as_float(s);
  } else {
    drop[j - a.K] = ch[(size_t)F_W * a.CH + s];
  }
}

// the sorted deposits: each bin's first adds its run in order
__global__ void __launch_bounds__(THREADS)
deposit_kernel(const unsigned* bins, const int* order, const float* vals,
               float* hist, const int* cnt) {
  const int used = cnt[CNT_USED];
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= used) return;
  const unsigned b = bins[j];
  if (j > 0 && bins[j - 1] == b) return;
  float acc = hist[b];
  for (int u = j; u < used && bins[u] == b; ++u) acc = acc + vals[order[u]];
  hist[b] = acc;
}

// a block-wide sum of one double per thread in a fixed order
__device__ double block_sum(double v, double* s_red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  double t = 0.0;
  for (int k = 0; k < RED_THREADS / 32; ++k) t += s_red[k];
  return t;
}

// the step's ledgers (t < 0: the launch rays' children), the step count,
// and the counters reset for the next step
__global__ void __launch_bounds__(RED_THREADS)
ledger_kernel(const Args a, const int* widths, int t, const float* pr,
              const float* drop, float* ledger, int* cnt) {
  __shared__ double s_red[RED_THREADS / 32];
  const int n = t < 0 ? a.R : widths[t];
  const int ndrop = max(0, cnt[CNT_LIVE] - a.K);
  double sa = 0.0, sb = 0.0, sd = 0.0;
  for (int i = threadIdx.x; i < n; i += RED_THREADS) {
    sa += pr[i];
    sb += pr[n + i];
  }
  for (int i = threadIdx.x; i < ndrop; i += RED_THREADS) sd += drop[i];
  sa = block_sum(sa, s_red);
  sb = block_sum(sb, s_red);
  sd = block_sum(sd, s_red);
  if (threadIdx.x == 0) {
    ledger[1] = ledger[1] + ((float)sa + (float)sb);
    ledger[0] = ledger[0] + (float)sd;
    if (t >= 0 && n > 0) cnt[CNT_STEPS] += 1;
    cnt[CNT_LIVE] = 0;
    cnt[CNT_USED] = 0;
  }
}

// ---------------------------------------------------------------------------
// the backward

// the adjoint of jones(): the matrix's (8) and the polarisation's (4)
__device__ __forceinline__ void jones_adjoint(const float* j, float ter,
                                              float tei, float tmr, float tmi,
                                              const float* d, float* dj,
                                              float* dp) {
  dj[0] = d[0] * ter + d[1] * tei;
  dj[1] = d[1] * ter - d[0] * tei;
  dj[2] = d[0] * tmr + d[1] * tmi;
  dj[3] = d[1] * tmr - d[0] * tmi;
  dj[4] = d[2] * ter + d[3] * tei;
  dj[5] = d[3] * ter - d[2] * tei;
  dj[6] = d[2] * tmr + d[3] * tmi;
  dj[7] = d[3] * tmr - d[2] * tmi;
  dp[0] = d[0] * j[0] + d[1] * j[1] + d[2] * j[4] + d[3] * j[5];
  dp[1] = d[1] * j[0] - d[0] * j[1] + d[3] * j[4] - d[2] * j[5];
  dp[2] = d[0] * j[2] + d[1] * j[3] + d[2] * j[6] + d[3] * j[7];
  dp[3] = d[1] * j[2] - d[0] * j[3] + d[3] * j[6] - d[2] * j[7];
}

// the adjoint of one child of a transport (splitting.py::_branch_adjoint):
// bp its polarisation before renormalisation, pw its power, D its
// direction row, lam its adjoint; the efficiency is pw * s * inv_cos
__device__ void branch_adjoint(const float* bp, float pw, const float* D,
                               const float* lam, float w, float inv_cos,
                               float s, float* dD, float* dbp, float& d_s,
                               float& d_ic) {
  const bool pos = pw > 1e-30f;
  const float inv = rsqrt_rn(pos ? pw : 1.0f);
  const float q2 = bp[2] * inv;
  const float q3 = bp[3] * inv;
  dD[0] = lam[A_X] + lam[A_GX];
  dD[1] = lam[A_Y] + lam[A_GY];
  dD[2] = lam[A_TMR] * q2 + lam[A_TMI] * q3;
  dD[3] = lam[A_TMI] * q2 - lam[A_TMR] * q3;
  const float dq2 = lam[A_TMR] * D[2] + lam[A_TMI] * D[3];
  const float dq3 = lam[A_TMI] * D[2] - lam[A_TMR] * D[3];
  const float dinv = lam[A_TER] * bp[0] + lam[A_TEI] * bp[1] + dq2 * bp[2]
                     + dq3 * bp[3];
  float dpw = pos ? dinv * -0.5f * inv * inv * inv : 0.0f;
  const float d_eff = lam[A_W] * w;
  const float dps = d_eff * inv_cos;
  dpw = dpw + dps * s;
  d_s = dps * pw;
  d_ic = d_eff * (pw * s);
  dbp[0] = lam[A_TER] * inv + (bp[0] + bp[0]) * dpw;
  dbp[1] = lam[A_TEI] * inv + (bp[1] + bp[1]) * dpw;
  dbp[2] = dq2 * inv + (bp[2] + bp[2]) * dpw;
  dbp[3] = dq3 * inv + (bp[3] + bp[3]) * dpw;
}

// step t's adjoint (splitting.py::_step_adjoint), one thread per slot of
// tape row `row`: children's adjoints from lam_in (zeroed as read), the
// slot's into lam_out at its provenance, the contributions staged with
// their table entries as sort keys (records [0, n), cells [n, 2n),
// direction rows A, B, hop [2n, 5n))
__global__ void __launch_bounds__(THREADS)
adjoint_kernel(const Args a, const float* row, const int* widths, int t,
               const float* gh, float* lam_in, float* lam_out, int LC,
               float* c_rec, float* c_cell, float* c_dirs, unsigned* keys,
               int* cnt) {
  const int n = widths[t];
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) cnt[CNT_ITEMS] = 5 * n;
  if (i >= n) return;
  const Ray r = load_ray(row, a.K, i);
  const int g = __float_as_int(row[(size_t)T_CID * a.K + i]);
  const int src = __float_as_int(row[(size_t)T_SRC * a.K + i]);
  const Cell c = cell_view(a, g);
  float la[NADJ], lb[NADJ];
  for (int f = 0; f < NADJ; ++f) {
    la[f] = lam_in[(size_t)f * LC + i];
    lb[f] = lam_in[(size_t)f * LC + n + i];
    lam_in[(size_t)f * LC + i] = 0.0f;
    lam_in[(size_t)f * LC + n + i] = 0.0f;
  }

  // the step's decisions and values, as step_children computes them
  const float x = r.x, y = r.y;
  const int state = r.st;
  bool in_r1, in_hull, in_r2;
  regions(c, x, y, in_r1, in_hull, in_r2);
  const bool alive = state < DEAD && in_r1;
  const bool grp_ic = alive && state <= 1;
  const bool grp_fc = alive && (state == 2 || state == 3);
  const bool grp_oc = alive && state >= 4;
  bool in_rect;
  const int key = site_key(c, x, y, state, grp_fc, grp_oc, c.num_fc,
                           c.num_oc, in_rect);
  const float* rec = c.rec + key * REC_W;
  const bool hit_fc = grp_fc && in_hull;
  const bool hit_oc = grp_oc && in_rect;
  const bool interact = grp_ic || hit_fc || hit_oc;
  float pol_a[4], pol_b[4], pol_c[4];
  jones(rec, r.ter, r.tei, r.tmr, r.tmi, pol_a);
  jones(rec + 8, r.ter, r.tei, r.tmr, r.tmi, pol_b);
  jones(rec + 16, r.ter, r.tei, r.tmr, r.tmi, pol_c);
  const float s_a = rec[24], s_b = rec[25];
  const bool cpos = r.cos > 0.0f;
  const float inv_cos = __fdiv_rn(1.0f, cpos ? r.cos : 1.0f);
  const float pw_a = power4(pol_a[0], pol_a[1], pol_a[2], pol_a[3]);
  const float pw_b = power4(pol_b[0], pol_b[1], pol_b[2], pol_b[3]);
  const float pw_c = power4(pol_c[0], pol_c[1], pol_c[2], pol_c[3]);
  const float eff_a = pw_a * s_a * inv_cos;
  const float eff_b = pw_b * s_b * inv_cos;
  const float s_c = c.cell[C_SOUT];
  const float eff_c = pw_c * s_c * inv_cos;
  const float dep = hit_oc ? r.w * eff_c : 0.0f;
  const bool miss_fc2 = grp_fc && !in_hull && state == 2;
  const bool miss_fc3 = grp_fc && !in_hull && state == 3;
  const bool hop = miss_fc2 || (miss_fc3 && in_r2)
                   || (grp_oc && !in_rect && state == 4);
  const bool not_int = alive && !interact;
  const int dir_a = grp_oc ? DIR_FC : DIR_IC;
  const int dir_b = grp_ic ? DIR_IC2 : (grp_fc ? DIR_FC : DIR_OC);
  const int hop_dir = miss_fc2 ? DIR_IC : DIR_FC;
  // child A's adjoint is the survivor's where the slot does not interact
  float lc[NADJ], ls[NADJ];
  for (int f = 0; f < NADJ; ++f) {
    lc[f] = interact ? la[f] : 0.0f;
    ls[f] = not_int ? la[f] : 0.0f;
    lb[f] = interact ? lb[f] : 0.0f;
  }

  // the deposit's adjoint
  const int base = grid_base(a, g);
  float d_dep, d_xd = 0.0f, d_yd = 0.0f;
  float d_e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (!a.soft) {
    bool in_quad;
    const int b = deposit_bin(c.cell + C_EBR, x, y, a.ny, a.nx, in_quad);
    const bool use = in_quad && dep != 0.0f;
    d_dep = use ? gh[base + b] : 0.0f;
  } else {
    Soft s;
    soft_bins(c.cell + C_EBR, x, y, a.ny, a.nx, s);
    const float wq = s.in_quad ? dep : 0.0f;
    float wf[4], gk[4], dwf[4];
    for (int k = 0; k < 4; ++k) {
      wf[k] = soft_weight(s, k);
      gk[k] = wq * wf[k] != 0.0f ? gh[base + soft_bin(s, k, a.nx)] : 0.0f;
    }
    const float d_wq = gk[0] * wf[0] + gk[1] * wf[1] + gk[2] * wf[2]
                       + gk[3] * wf[3];
    for (int k = 0; k < 4; ++k) dwf[k] = gk[k] * wq;
    const float d_ax = dwf[0] * s.ay + dwf[2] * s.fy;
    const float d_ay = dwf[0] * s.ax + dwf[1] * s.fx;
    const float d_fx = dwf[1] * s.ay + dwf[3] * s.fy - d_ax;
    const float d_fy = dwf[2] * s.ax + dwf[3] * s.fx - d_ay;
    const float d_u = (s.pu >= 0.0f && s.pu <= (float)(a.nx - 1)) ? d_fx
                                                                  : 0.0f;
    const float d_v = (s.pv >= 0.0f && s.pv <= (float)(a.ny - 1)) ? d_fy
                                                                  : 0.0f;
    d_xd = __fdiv_rn(d_u, s.dxb);
    d_yd = __fdiv_rn(d_v, s.dyb);
    const float d_spx = __fdiv_rn(__fdiv_rn(-(d_u * s.qx), s.dxb),
                                  (float)a.nx);
    const float d_spy = __fdiv_rn(__fdiv_rn(-(d_v * s.qy), s.dyb),
                                  (float)a.ny);
    d_e[0] = -d_xd - d_spx;
    d_e[1] = d_spx;
    d_e[2] = -d_yd - d_spy;
    d_e[3] = d_spy;
    d_dep = s.in_quad ? d_wq : 0.0f;
  }
  d_dep = hit_oc ? d_dep : 0.0f;

  // the two children and the deposit
  const float* Da = c.dirs + DIR_W * dir_a;
  const float* Db = c.dirs + DIR_W * dir_b;
  float dDa[4], dDb[4], dbpa[4], dbpb[4], dbpc[4];
  float dsa, dsb, dica, dicb;
  branch_adjoint(pol_a, pw_a, Da, lc, r.w, inv_cos, s_a, dDa, dbpa, dsa,
                 dica);
  branch_adjoint(pol_b, pw_b, Db, lb, r.w, inv_cos, s_b, dDb, dbpb, dsb,
                 dicb);
  const float d_effc = d_dep * r.w;
  const float dpcs = d_effc * inv_cos;
  const float dpwc = dpcs * s_c;
  const float d_sc = dpcs * pw_c;
  const float dicc = d_effc * (pw_c * s_c);
  for (int k = 0; k < 4; ++k) dbpc[k] = (pol_c[k] + pol_c[k]) * dpwc;
  float* cr = c_rec + (size_t)i * REC_W;
  float dpa[4], dpb[4], dpc[4], dj[8];
  jones_adjoint(rec, r.ter, r.tei, r.tmr, r.tmi, dbpa, dj, dpa);
  for (int k = 0; k < 8; ++k) cr[k] = dj[k];
  jones_adjoint(rec + 8, r.ter, r.tei, r.tmr, r.tmi, dbpb, dj, dpb);
  for (int k = 0; k < 8; ++k) cr[8 + k] = dj[k];
  jones_adjoint(rec + 16, r.ter, r.tei, r.tmr, r.tmi, dbpc, dj, dpc);
  for (int k = 0; k < 8; ++k) cr[16 + k] = dj[k];
  cr[24] = lc[A_COS] + dsa;
  cr[25] = lb[A_COS] + dsb;
  const float d_ic = dica + dicb + dicc;
  const float d_cos = cpos ? -(d_ic * inv_cos * inv_cos) : 0.0f;

  // the survivor: a hop adds the gap and turns the TM phase
  const float* hd = c.dirs + DIR_W * hop_dir + 4;
  const float s_tmr = hop ? ls[A_TMR] * hd[0] + ls[A_TMI] * hd[1]
                          : ls[A_TMR];
  const float s_tmi = hop ? ls[A_TMI] * hd[0] - ls[A_TMR] * hd[1]
                          : ls[A_TMI];
  const float dh4 = hop ? ls[A_TMR] * r.tmr + ls[A_TMI] * r.tmi : 0.0f;
  const float dh5 = hop ? ls[A_TMI] * r.tmr - ls[A_TMR] * r.tmi : 0.0f;

  float lam[NADJ];
  lam[A_X] = lc[A_X] + lb[A_X] + ls[A_X] + d_xd;
  lam[A_Y] = lc[A_Y] + lb[A_Y] + ls[A_Y] + d_yd;
  lam[A_TER] = dpa[0] + dpb[0] + dpc[0] + ls[A_TER];
  lam[A_TEI] = dpa[1] + dpb[1] + dpc[1] + ls[A_TEI];
  lam[A_TMR] = dpa[2] + dpb[2] + dpc[2] + s_tmr;
  lam[A_TMI] = dpa[3] + dpb[3] + dpc[3] + s_tmi;
  lam[A_COS] = d_cos + ls[A_COS];
  lam[A_GX] = (hop ? ls[A_X] : 0.0f) + ls[A_GX];
  lam[A_GY] = (hop ? ls[A_Y] : 0.0f) + ls[A_GY];
  lam[A_W] = lc[A_W] * eff_a + lb[A_W] * eff_b + d_dep * eff_c + ls[A_W];
  for (int f = 0; f < NADJ; ++f) lam_out[(size_t)f * LC + src] = lam[f];

  float* cc = c_cell + (size_t)i * CELL_W;
  for (int k = 0; k < C_SOUT; ++k) cc[k] = 0.0f;
  cc[C_SOUT] = d_sc;
  for (int k = 0; k < 4; ++k) cc[C_EBR + k] = d_e[k];
  float* cd = c_dirs + (size_t)i * DIR_W;
  const size_t nd = (size_t)n * DIR_W;
  for (int k = 0; k < 4; ++k) {
    cd[k] = dDa[k];
    cd[nd + k] = dDb[k];
    cd[2 * nd + k] = 0.0f;
  }
  cd[4] = 0.0f;
  cd[5] = 0.0f;
  cd[nd + 4] = 0.0f;
  cd[nd + 5] = 0.0f;
  cd[2 * nd + 4] = dh4;
  cd[2 * nd + 5] = dh5;
  const unsigned dbase = (unsigned)(a.E + a.C + g * 4);
  keys[i] = (unsigned)(g * a.R2 + key);
  keys[n + i] = (unsigned)(a.E + g);
  keys[2 * n + i] = dbase + dir_a;
  keys[3 * n + i] = dbase + dir_b;
  keys[4 * n + i] = dbase + hop_dir;
}

// split_init's adjoint (splitting.py::_init_adjoint), one thread per launch
// ray: cells [0, 2R) (A of ray r at r, B at R + r), direction rows
// [2R, 4R)
__global__ void __launch_bounds__(THREADS)
init_adjoint_kernel(const Args a, float* lam_in, int LC, float* c_cell,
                    float* c_dirs, unsigned* keys, int* cnt) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i == 0) cnt[CNT_ITEMS] = 4 * a.R;
  if (i >= a.R) return;
  const int g = a.cid0[i];
  const Cell c = cell_view(a, g);
  float s[6];
  for (int f = 0; f < 6; ++f) s[f] = a.rays[(size_t)f * a.R + i];
  const float w0 = fabsf(s[2]) + fabsf(s[3]) + fabsf(s[4]) + fabsf(s[5]);
  const float w = w0 > 0.0f ? 1.0f : 0.0f;
  for (int branch = 0; branch < 2; ++branch) {
    const int j = branch * a.R + i;
    float lam[NADJ];
    for (int f = 0; f < NADJ; ++f) {
      lam[f] = lam_in[(size_t)f * LC + j];
      lam_in[(size_t)f * LC + j] = 0.0f;
    }
    const int jo = branch == 0 ? I_JA : I_JB;
    const int so = branch == 0 ? I_SA : I_SB;
    const int ico = branch == 0 ? I_ICA : I_ICB;
    const int dir = branch == 0 ? DIR_IC : DIR_IC2;
    float p[4];
    jones(c.cell + jo, s[2], s[3], s[4], s[5], p);
    const float pw = power4(p[0], p[1], p[2], p[3]);
    const float c0 = c.cell[I_COS0];
    const float eff = __fdiv_rn(pw * c.cell[so], c0);
    const float* D = c.dirs + DIR_W * dir;
    const bool pos = pw > 1e-30f;
    const float inv = rsqrt_rn(pos ? pw : 1.0f);
    const float q2 = p[2] * inv;
    const float q3 = p[3] * inv;
    float* cd = c_dirs + (size_t)j * DIR_W;
    cd[0] = lam[A_X] + lam[A_GX];
    cd[1] = lam[A_Y] + lam[A_GY];
    cd[2] = lam[A_TMR] * q2 + lam[A_TMI] * q3;
    cd[3] = lam[A_TMI] * q2 - lam[A_TMR] * q3;
    cd[4] = 0.0f;
    cd[5] = 0.0f;
    const float dq2 = lam[A_TMR] * D[2] + lam[A_TMI] * D[3];
    const float dq3 = lam[A_TMI] * D[2] - lam[A_TMR] * D[3];
    const float dinv = lam[A_TER] * p[0] + lam[A_TEI] * p[1] + dq2 * p[2]
                       + dq3 * p[3];
    float dpw = pos ? dinv * -0.5f * inv * inv * inv : 0.0f;
    const float d_eff = lam[A_W] * w;
    const float d_num = __fdiv_rn(d_eff, c0);
    const float d_c0 = __fdiv_rn(-(d_eff * eff), c0);
    dpw = dpw + d_num * c.cell[so];
    const float d_so = d_num * pw;
    float dp[4], dj[8], dpol[4];
    dp[0] = lam[A_TER] * inv + (p[0] + p[0]) * dpw;
    dp[1] = lam[A_TEI] * inv + (p[1] + p[1]) * dpw;
    dp[2] = dq2 * inv + (p[2] + p[2]) * dpw;
    dp[3] = dq3 * inv + (p[3] + p[3]) * dpw;
    jones_adjoint(c.cell + jo, s[2], s[3], s[4], s[5], dp, dj, dpol);
    float* cc = c_cell + (size_t)j * CELL_W;
    for (int k = 0; k < CELL_W; ++k) cc[k] = 0.0f;
    for (int k = 0; k < 8; ++k) cc[jo + k] = dj[k];
    cc[so] = d_so;
    cc[I_COS0] = d_c0;
    cc[ico] = lam[A_COS];
    keys[j] = (unsigned)(a.E + g);
    keys[2 * a.R + j] = (unsigned)(a.E + a.C + g * 4 + dir);
  }
}

// the sorted contributions: each table entry's first adds the entry's run
// in list order (t < 0: the launch rays' lists)
__global__ void __launch_bounds__(THREADS)
table_add_kernel(const Args a, const int* widths, int t,
                 const unsigned* ents, const int* order, const float* c_rec,
                 const float* c_cell, const float* c_dirs, float* d_rec,
                 float* d_cell, float* d_dirs, const int* cnt) {
  const int items = cnt[CNT_ITEMS];
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= items) return;
  const unsigned e = ents[j];
  if (j > 0 && ents[j - 1] == e) return;
  const int n = t < 0 ? 0 : widths[t];
  const int rec_end = n;
  const int cell_end = t < 0 ? 2 * a.R : 2 * n;
  float* dst;
  const float* src;
  int width, off;
  if (e < (unsigned)a.E) {
    dst = d_rec + (size_t)e * REC_W;
    src = c_rec;
    width = REC_W;
    off = 0;
  } else if (e < (unsigned)(a.E + a.C)) {
    dst = d_cell + (size_t)(e - a.E) * CELL_W;
    src = c_cell;
    width = CELL_W;
    off = rec_end;
  } else {
    dst = d_dirs + (size_t)(e - a.E - a.C) * DIR_W;
    src = c_dirs;
    width = DIR_W;
    off = cell_end;
  }
  for (int k = 0; k < width; ++k) {
    float acc = dst[k];
    for (int u = j; u < items && ents[u] == e; ++u)
      acc = acc + src[(size_t)(order[u] - off) * width + k];
    dst[k] = acc;
  }
}

// ---------------------------------------------------------------------------
// scratch layouts

size_t align_up(size_t v) { return (v + 255) & ~(size_t)255; }

struct Carve {
  char* base;
  size_t at;
  template <typename T>
  T* take(size_t n) {
    T* p = base ? reinterpret_cast<T*>(base + at) : nullptr;
    at += align_up(n * sizeof(T));
    return p;
  }
};

struct FwdScratch {
  float* ch;             // (NCH, CH) children
  SortBuf sk;            // the children's sort, CH pairs
  float* pr;             // (CH,) pruned weight of each child
  float* drop;           // (CH,) weights past the capacity
  SortBuf sd;            // the deposits' sort, DN pairs
  float* dvals;          // (DN,)
};

size_t fwd_scratch(const Args& a, char* base, FwdScratch& s) {
  const size_t DN = (size_t)(a.soft ? 4 : 1) * a.K;
  const size_t nmax = (size_t)a.CH > DN ? (size_t)a.CH : DN;
  Carve c{base, 0};
  s.ch = c.take<float>((size_t)NCH * a.CH);
  for (int b = 0; b < 2; ++b) {
    s.sk.k[b] = c.take<unsigned>(a.CH);
    s.sk.v[b] = c.take<int>(a.CH);
    s.sd.k[b] = c.take<unsigned>(DN);
    s.sd.v[b] = c.take<int>(DN);
  }
  s.sk.counts = s.sd.counts = c.take<unsigned>(RADIX * ((nmax + TILE - 1)
                                                         / TILE));
  s.pr = c.take<float>(a.CH);
  s.drop = c.take<float>(a.CH);
  s.dvals = c.take<float>(DN);
  return c.at;
}

struct BwdScratch {
  float* lam;            // (2, NADJ, LC) children's adjoints, two levels
  int LC;
  float* c_rec;          // (K, 26)
  float* c_cell;         // (max(K, 2R), 26)
  float* c_dirs;         // (max(3K, 2R), 6)
  SortBuf sc;            // the contributions' sort, max(5K, 4R) pairs
  int NI;
};

size_t bwd_scratch(const Args& a, char* base, BwdScratch& s) {
  s.LC = a.CH;
  s.NI = 5 * a.K > 4 * a.R ? 5 * a.K : 4 * a.R;
  Carve c{base, 0};
  s.lam = c.take<float>((size_t)2 * NADJ * s.LC);
  s.c_rec = c.take<float>((size_t)a.K * REC_W);
  s.c_cell = c.take<float>((size_t)(a.K > 2 * a.R ? a.K : 2 * a.R) * CELL_W);
  s.c_dirs = c.take<float>((size_t)(3 * a.K > 2 * a.R ? 3 * a.K : 2 * a.R)
                           * DIR_W);
  for (int b = 0; b < 2; ++b) {
    s.sc.k[b] = c.take<unsigned>(s.NI);
    s.sc.v[b] = c.take<int>(s.NI);
  }
  s.sc.counts = c.take<unsigned>(RADIX * ((s.NI + TILE - 1) / TILE));
  return c.at;
}

bool params_ok(const int* p) {
  return p[P_R] >= 0 && p[P_K] > 0 && p[P_C] > 0
         && p[P_R2] == 2 * (1 + p[P_NUM_FC] + p[P_NUM_OC])
         && p[P_E] == p[P_C] * p[P_R2] && p[P_NUM_FC] >= 1
         && p[P_NUM_OC] >= 1 && p[P_NY] >= 2 && p[P_NX] >= 2
         && p[P_M] >= 1 && p[P_N] >= 1 && p[P_GRID_N] >= 1
         && p[P_HIST] > 0 && p[P_E_IC] >= 0 && p[P_E_R1] >= 0
         && p[P_E_R2] >= 0 && p[P_E_HULL] >= 0 && p[P_T0] >= 0
         && p[P_NSTEPS] >= 0
         // keys: a bin (or hist) and the table entries in 32 bits, children
         // indices in 31
         && (long long)p[P_E] + 5LL * p[P_C] < (1LL << 31)
         && 2LL * (p[P_R] > p[P_K] ? p[P_R] : p[P_K]) < (1LL << 30);
}

int blocks_of(long long n) { return (int)((n + THREADS - 1) / THREADS); }

#define CHECK_LAUNCH()                          \
  do {                                          \
    const cudaError_t e_ = cudaGetLastError();  \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

}  // namespace

// Scratch bytes of split_trace_forward (backward = 0) or
// split_trace_backward (1) with the int parameters p.
extern "C" size_t split_trace_scratch_bytes(const int* p, int backward) {
  const Args a = make_args(p, 0.0f, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr);
  if (backward) {
    BwdScratch s;
    return bwd_scratch(a, nullptr, s);
  }
  FwdScratch s;
  return fwd_scratch(a, nullptr, s);
}

// The forward on `stream`: with p[P_INIT], the launch rays' children into
// tape row 0; then steps p[P_T0] .. p[P_T0] + p[P_NSTEPS] - 1, step t
// sweeping row t into row t + 1 (p[P_RING]: rows t & 1 and (t + 1) & 1),
// its deposits into hist and its ledgers into ledger (trunc, pruned).
// counters: int[8] (zero before the first call), widths: int[steps + 1].
// Returns a cudaError_t code (0: launched).
extern "C" int split_trace_forward(
    const int* p, float thr, const void* rec, const void* cell,
    const void* dirs, const void* geom, const void* grid, const void* rays,
    const void* cid, void* tape, void* widths, void* hist, void* ledger,
    void* counters, void* scratch, void* stream) {
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(p, thr, rec, cell, dirs, geom, grid, rays, cid);
  FwdScratch s;
  fwd_scratch(a, static_cast<char*>(scratch), s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* rows = static_cast<float*>(tape);
  int* w = static_cast<int*>(widths);
  int* cnt = static_cast<int*>(counters);
  float* h = static_cast<float*>(hist);
  float* led = static_cast<float*>(ledger);
  const size_t row = (size_t)NT * a.K;
  const int DN = (a.soft ? 4 : 1) * a.K;
  const int dbits = bit_length((unsigned)a.hist);
  cudaError_t err;
  if (p[P_INIT]) {
    if (a.R > 0)
      init_kernel<<<blocks_of(a.R), THREADS, 0, st>>>(a, s.ch, s.sk.k[0],
                                                      s.pr, cnt);
    CHECK_LAUNCH();
    const int o = radix_sort(s.sk, cnt + CNT_ITEMS, 2 * a.R, 32, st, err);
    if (err != cudaSuccess) return (int)err;
    compact_kernel<<<blocks_of(a.CH), THREADS, 0, st>>>(
        a, s.ch, s.sk.v[o], rows, w, 0, s.drop, cnt);
    ledger_kernel<<<1, RED_THREADS, 0, st>>>(a, w, -1, s.pr, s.drop, led,
                                             cnt);
    CHECK_LAUNCH();
  }
  for (int t = p[P_T0]; t < p[P_T0] + p[P_NSTEPS]; ++t) {
    const size_t r_in = p[P_RING] ? (size_t)(t & 1) : (size_t)t;
    const size_t r_out = p[P_RING] ? (size_t)((t + 1) & 1) : (size_t)t + 1;
    step_kernel<<<blocks_of(a.K), THREADS, 0, st>>>(
        a, rows + r_in * row, w, t, s.ch, s.sk.k[0], s.pr, s.sd.k[0],
        s.dvals, cnt);
    CHECK_LAUNCH();
    const int o = radix_sort(s.sk, cnt + CNT_ITEMS, 2 * a.K, 32, st, err);
    if (err != cudaSuccess) return (int)err;
    compact_kernel<<<blocks_of(2 * a.K), THREADS, 0, st>>>(
        a, s.ch, s.sk.v[o], rows + r_out * row, w, t + 1, s.drop, cnt);
    CHECK_LAUNCH();
    const int od = radix_sort(s.sd, cnt + CNT_DEPS, DN, dbits, st, err);
    if (err != cudaSuccess) return (int)err;
    deposit_kernel<<<blocks_of(DN), THREADS, 0, st>>>(
        s.sd.k[od], s.sd.v[od], s.dvals, h, cnt);
    ledger_kernel<<<1, RED_THREADS, 0, st>>>(a, w, t, s.pr, s.drop, led,
                                             cnt);
    CHECK_LAUNCH();
  }
  return 0;
}

// The backward on `stream` over the p[P_T0] steps of a forward's tape
// (rows 0 .. p[P_T0], widths alike): the tables' adjoints, entry-major as
// the tables, added into d_rec, d_cell, d_dirs (zero before the call).
// counters: int[8]. Returns a cudaError_t code (0: launched).
extern "C" int split_trace_backward(
    const int* p, const void* rec, const void* cell, const void* dirs,
    const void* geom, const void* grid, const void* rays, const void* cid,
    const void* tape, const void* widths, const void* grad_hist,
    void* d_rec, void* d_cell, void* d_dirs, void* counters, void* scratch,
    void* stream) {
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  const Args a = make_args(p, 0.0f, rec, cell, dirs, geom, grid, rays, cid);
  BwdScratch s;
  bwd_scratch(a, static_cast<char*>(scratch), s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rows = static_cast<const float*>(tape);
  const int* w = static_cast<const int*>(widths);
  int* cnt = static_cast<int*>(counters);
  const float* gh = static_cast<const float*>(grad_hist);
  float* dr = static_cast<float*>(d_rec);
  float* dc = static_cast<float*>(d_cell);
  float* dd = static_cast<float*>(d_dirs);
  const size_t row = (size_t)NT * a.K;
  const size_t level = (size_t)NADJ * s.LC;
  const int bits = bit_length((unsigned)(a.E + 5 * a.C));
  cudaError_t err = cudaMemsetAsync(s.lam, 0, 2 * level * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  for (int t = p[P_T0] - 1; t >= 0; --t) {
    adjoint_kernel<<<blocks_of(a.K), THREADS, 0, st>>>(
        a, rows + (size_t)t * row, w, t, gh, s.lam + (size_t)(t & 1) * level,
        s.lam + (size_t)((t + 1) & 1) * level, s.LC, s.c_rec, s.c_cell,
        s.c_dirs, s.sc.k[0], cnt);
    CHECK_LAUNCH();
    const int o = radix_sort(s.sc, cnt + CNT_ITEMS, 5 * a.K, bits, st, err);
    if (err != cudaSuccess) return (int)err;
    table_add_kernel<<<blocks_of(5 * a.K), THREADS, 0, st>>>(
        a, w, t, s.sc.k[o], s.sc.v[o], s.c_rec, s.c_cell, s.c_dirs, dr, dc,
        dd, cnt);
    CHECK_LAUNCH();
  }
  if (a.R > 0) {
    init_adjoint_kernel<<<blocks_of(a.R), THREADS, 0, st>>>(
        a, s.lam + level, s.LC, s.c_cell, s.c_dirs, s.sc.k[0], cnt);
    CHECK_LAUNCH();
    const int o = radix_sort(s.sc, cnt + CNT_ITEMS, 4 * a.R, bits, st, err);
    if (err != cudaSuccess) return (int)err;
    table_add_kernel<<<blocks_of(4 * a.R), THREADS, 0, st>>>(
        a, w, -1, s.sc.k[o], s.sc.v[o], s.c_rec, s.c_cell, s.c_dirs, dr, dc,
        dd, cnt);
    CHECK_LAUNCH();
  }
  return 0;
}

extern "C" const char* split_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
