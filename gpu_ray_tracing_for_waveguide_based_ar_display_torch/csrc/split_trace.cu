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
// an explicit reverse sweep over a tape.
//
// Each direction is one cooperative persistent kernel a call
// (cudaLaunchCooperativeKernel: every block resident, so a grid-wide
// barrier is safe).  The grid is min(the blocks of one step's widest
// phase, resident blocks per SM x SMs); every phase is a grid-stride loop,
// so any width runs on that grid, and a barrier in device memory
// (grid_sync) separates the phases.  The stop test is decided on the card:
// after each step every block reads the new width and all leave together
// when it is 0; the host reads only the step count, once, at the end.
//
// Forward, a step (9 barriers): one thread per slot takes the slot to its
// two children, its deposit(s) and its pruned weights with the plain
// version's float32 operations in its order (the step transport of
// split_common.cuh, shared with split_cells.cu); the children (A of slot s
// at s, B at width + s) are sorted by a stable LSD radix sort on their
// weight, heaviest first (key ~bits(w), dead children last), and the first
// min(K, live) go into the next wavefront with their provenance (the
// sort's last pass places them there itself); the rest of the live ones go
// to the truncated ledger.  The step's deposits
// ((corner, slot) order: one round per corner in soft binning) are sorted
// by bin with the same sort, side by side with the children's passes, and
// the first deposit of each bin adds the bin's run in that order: every bin
// adds its deposits one by one in the plain version's order, with no float
// atomics.  A sort pass is two phases: each block counts the digits of a
// contiguous range of items and the last block to finish scans the counts
// (a ticket, no barrier of its own); then each block scatters its range in
// ascending order, so the sort is stable.  The last block sums the
// ledgers in float64 in a fixed order (that of a 1,024-thread block) while
// the others start the next step; their buffers alternate by step parity.
//
// Backward, a step from the last to the first (2 + 2 x passes barriers),
// then the launch rays: one thread per slot of the step's tape row reads
// its children's adjoints (written by the step after it at the children's
// provenance, zeroed as read), recomputes the step's decisions and values,
// writes its own adjoint at its provenance, and stages its table
// contributions (its record, its cell's out-coupling scale and deposit
// rectangle, its three direction rows); the contributions are sorted by
// table entry (stable, so in list order: slots in order, direction rows A,
// B, then the hops).  The table add is warp-wide: a warp takes 32 sorted
// contributions and every run that starts among them, its lanes the
// entry's columns (26, or 6 for a direction row); it walks each run once in
// list order with its rows' loads issued ahead of the add chain, so a
// crowded entry costs one coalesced pass, not one thread re-walking the run
// per column.  The arithmetic is the plain backward's, so the two agree bit
// for bit; two runs give identical bits.
//
// What bounds it on an H100: the bytes a stepped slot must move
// (chip_smoke.py's SPLIT_TRACE_BYTES: 100 B forward, 132 B backward) come
// to 12-75 us a call at chip_smoke.py phase 23's widths, the float32 work
// (about 230 operations a slot forward, 450 backward) to less.  What the
// design pays instead is latency, phase by phase: 9 barriers a step forward
// (the step, then four sort passes of two phases each; the compaction
// rides on the last pass and the deposits' adds on a counting phase) and
// 2 + 2 x passes backward (6 at optimize's table sizes), each a round trip
// of every block through one L2 word, and within each phase a dependent
// chain: a slot's step or adjoint on one thread (hundreds of float32
// operations without contraction and its table loads), the sort's scan by
// the last block to count, a crowded entry's run of adds.  The grid is kept
// to the blocks a step's widths need, since a barrier costs more with more
// blocks, and every phase's loads that do not depend on each other are
// issued together.  tools/split_trace_phases.py times each phase and the
// barrier alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

namespace {

constexpr int THREADS = 256;          // one slot (or child, or item) a thread
constexpr int LEDGER_THREADS = 1024;  // the ledger's order: a 1,024-thread sum
constexpr int NT = 13;                // tape fields: the NF, cid, src
constexpr int T_CID = 11, T_SRC = 12;
constexpr int NCH = 12;               // children buffer fields: NF, cid
constexpr int NADJ = 10;              // a slot's adjoint
enum { A_X, A_Y, A_TER, A_TEI, A_TMR, A_TMI, A_COS, A_GX, A_GY, A_W };
constexpr int RADIX = 256;            // == THREADS: a thread per digit
constexpr int SORT_WARPS = THREADS / 32;
constexpr int SCAN_AHEAD = 16;        // the scan's loads in flight
constexpr unsigned NO_KEY = 0xFFFFFFFFu;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int ADD_GROUP = 16;         // contributions whose loads go ahead

// the int parameters (engine/splitting.py::TRACE_PARAMS)
enum { P_R, P_K, P_E, P_C, P_R2, P_NUM_FC, P_NUM_OC, P_NY, P_NX, P_M, P_N,
       P_HIST, P_SOFT, P_CIRCLE, P_GRID_N, P_E_IC, P_E_R1, P_E_R2, P_E_HULL,
       P_STEPS, P_RING, NPARAM };
// device counters (engine/splitting.py::_NCNT, _CNT_STEPS, _CNT_BARRIERS):
// live children and used deposits by step parity, the steps taken, the
// barrier's arrivals and generation (the barriers passed), the sorts'
// tickets
enum { CNT_LIVE = 0, CNT_USED = 2, CNT_STEPS = 4, CNT_BAR = 5,
       CNT_BAR_GEN = 6, CNT_TICK = 7, NCNT = 16 };

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
// the grid: a barrier, counters, grid-stride loops

// a counter or width written by another block before the last barrier
__device__ __forceinline__ int load_shared_int(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

// every block of the (co-resident) grid waits here for all the others;
// what a block wrote before it is seen by every block after it.  bar[0]
// counts the arrivals, bar[1] the barriers passed.  A wait of more than
// about 2^35 cycles (some 20 s) traps: a launch error, not a hung card.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      const long long t0 = clock64();
      while (*gen == g) {
        if (clock64() - t0 > (1LL << 35)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// a count summed over the block's threads, added to *ctr once a warp
__device__ __forceinline__ void count_add(int* ctr, int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(ctr, v);
}

#define GRID_LOOP(i, n)                                             \
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < (n);         \
       i += gridDim.x * THREADS)

// ---------------------------------------------------------------------------
// the stable LSD radix sort of (key, index) pairs, 8 bits a pass.  A block
// takes a contiguous range of rounds of THREADS items, in ascending order,
// so the sort is stable.

// the sort's buffers: keys and indices, two of each; the blocks' digit
// counts (grid, RADIX), scanned in place, and the digit offsets (RADIX)
struct SortBuf {
  unsigned* k[2];
  int* v[2];
  unsigned* agg;
  unsigned* off;
};

struct SortShared {
  unsigned base[RADIX];
  unsigned wc[SORT_WARPS][RADIX];
  unsigned wsum[SORT_WARPS];
  int last;
};

// the rounds [lo, hi) of the n items that this block takes, and the blocks
// that take any
__device__ __forceinline__ void sort_range(int n, int& lo, int& hi,
                                           int& active) {
  const int nr = (n + THREADS - 1) / THREADS;
  const int per = (nr + (int)gridDim.x - 1) / (int)gridDim.x;
  active = (nr + per - 1) / per;
  lo = min(nr, (int)blockIdx.x * per);
  hi = min(nr, lo + per);
}

// a pass's counts: the block's digits into agg[block]; the last block of
// the pass to finish (its ticket) scans them: agg[b][d] becomes the count
// of digit d in the blocks before b, off[d] the items of smaller digits
__device__ void sort_hist(const SortBuf& s, int in, int n, int shift,
                          int* tick, SortShared& sh) {
  int lo, hi, active;
  sort_range(n, lo, hi, active);
  if (lo >= hi) return;
  const int tid = threadIdx.x;
  const unsigned* keys = s.k[in];
  sh.base[tid] = 0u;
  __syncthreads();
  for (int r = lo; r < hi; ++r) {
    const int i = r * THREADS + tid;
    if (i < n) atomicAdd(&sh.base[(keys[i] >> shift) & (RADIX - 1)], 1u);
  }
  __syncthreads();
  s.agg[(size_t)blockIdx.x * RADIX + tid] = sh.base[tid];
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(tick, 1) == active - 1;
    if (last) __threadfence();
    sh.last = last;
  }
  __syncthreads();
  if (!sh.last) return;
  unsigned run = 0u;
  for (int b = 0; b < active; b += SCAN_AHEAD) {
    unsigned c[SCAN_AHEAD];
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q)
      c[q] = b + q < active ? __ldcg(&s.agg[(size_t)(b + q) * RADIX + tid])
                            : 0u;
#pragma unroll
    for (int q = 0; q < SCAN_AHEAD; ++q) {
      if (b + q < active) {
        s.agg[(size_t)(b + q) * RADIX + tid] = run;
        run += c[q];
      }
    }
  }
  // the digit totals' exclusive scan: in each warp by shuffles, then the
  // warps' sums
  const int lane = tid & 31, warp = tid >> 5;
  unsigned incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sh.wsum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += sh.wsum[w];
  s.off[tid] = incl - run;
  if (tid == 0) *tick = 0;
}

// a pair to its place in the other buffers
struct ScatterTo {
  unsigned* kout;
  int* vout;
  __device__ void operator()(unsigned pos, unsigned key, int v) const {
    kout[pos] = key;
    vout[pos] = v;
  }
};

// each item of the block's range to its place: its digit's offset for the
// block, plus the items of that digit before it in the range (in item
// order: stable); pass 0 takes the items' own indices.  place(pos, key,
// index) puts it there.
template <class Place>
__device__ void sort_scatter(const SortBuf& s, int in, int n, int shift,
                             SortShared& sh, const Place& place) {
  int lo, hi, active;
  sort_range(n, lo, hi, active);
  if (lo >= hi) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned* kin = s.k[in];
  const int* vin = shift == 0 ? nullptr : s.v[in];
  sh.base[tid] = __ldcg(&s.agg[(size_t)blockIdx.x * RADIX + tid])
                 + __ldcg(&s.off[tid]);
  for (int r = lo; r < hi; ++r) {
    const int i = r * THREADS + tid;
    const bool valid = i < n;
    const unsigned key = valid ? kin[i] : 0u;
    const int d = valid ? (int)((key >> shift) & (RADIX - 1)) : RADIX;
    for (int w = 0; w < SORT_WARPS; ++w) sh.wc[w][tid] = 0u;
    __syncthreads();
    const unsigned peers = __match_any_sync(FULL, d);
    const unsigned rank = __popc(peers & ((1u << lane) - 1u));
    if (valid && rank == 0u) sh.wc[warp][d] = __popc(peers);
    __syncthreads();
    unsigned run = sh.base[tid];
    for (int w = 0; w < SORT_WARPS; ++w) {
      const unsigned c = sh.wc[w][tid];
      sh.wc[w][tid] = run;
      run += c;
    }
    sh.base[tid] = run;
    __syncthreads();
    if (valid) place(sh.wc[warp][d] + rank, key, vin ? vin[i] : i);
    __syncthreads();
  }
}

__device__ void sort_scatter(const SortBuf& s, int in, int n, int shift,
                             SortShared& sh) {
  sort_scatter(s, in, n, shift, sh, ScatterTo{s.k[in ^ 1], s.v[in ^ 1]});
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

// the forward's tensors and scratch
struct Fwd {
  float* tape;           // (rows, NT, K)
  int* widths;           // (steps + 1,)
  float* hist;
  float* ledger;         // trunc, pruned
  int* cnt;              // NCNT counters
  float* ch;             // (NCH, CH) children
  SortBuf sk;            // the children's sort, CH pairs
  SortBuf sd;            // the deposits' sort, DN pairs
  float* pr[2];          // (CH,) pruned weight of each child, by parity
  float* drop;           // (CH,) weights past the capacity
  float* dvals;          // (DN,)
  int steps, ring, dpasses;
};

// a child into the children buffer (NCH fields of CH), with its sort key;
// returns whether it lives
__device__ __forceinline__ int put_child(const Args& a, float* ch,
                                         unsigned* keys, int j,
                                         const Ray& r, int g) {
  store_ray(ch, a.CH, j, r);
  ch[(size_t)T_CID * a.CH + j] = __int_as_float(g);
  const bool live = r.st < DEAD;
  // a live weight exceeds the threshold (>= 0): positive, so its bits order
  // it and ~bits sorts the heaviest first; no live key is NO_KEY
  keys[j] = live ? ~__float_as_uint(r.w) : NO_KEY;
  return live ? 1 : 0;
}

// the launch rays' children (tape row 0's candidates)
__device__ void init_phase(const Args& a, const Fwd& f) {
  int live = 0;
  float* pr = f.pr[1];
  GRID_LOOP(i, a.R) {
    const int g = a.cid0[i];
    const Cell c = cell_view(a, g);
    float s[6];
    for (int q = 0; q < 6; ++q) s[q] = a.rays[(size_t)q * a.R + i];
    Ray ra, rb;
    float pa, pb;
    init_children(c, s, ra, rb, pa, pb);
    live += put_child(a, f.ch, f.sk.k[0], i, ra, g);
    live += put_child(a, f.ch, f.sk.k[0], a.R + i, rb, g);
    pr[i] = pa;
    pr[a.R + i] = pb;
  }
  count_add(&f.cnt[CNT_LIVE + 1], live);
}

// step t over tape row `row` (n slots): children, pruned weights and
// deposits
__device__ void step_phase(const Args& a, const Fwd& f, const float* row,
                           int t, int n) {
  int live = 0, used = 0;
  float* pr = f.pr[t & 1];
  unsigned* dkeys = f.sd.k[0];
  GRID_LOOP(i, n) {
    const Ray r = load_ray(row, a.K, i);
    const int g = __float_as_int(row[(size_t)T_CID * a.K + i]);
    const Cell c = cell_view(a, g);
    Ray ca, cb;
    int dbin;
    float dw, pa, pb;
    step_children(c, r, ca, cb, dbin, dw, pa, pb);
    live += put_child(a, f.ch, f.sk.k[0], i, ca, g);
    live += put_child(a, f.ch, f.sk.k[0], n + i, cb, g);
    pr[i] = pa;
    pr[n + i] = pb;
    const int base = grid_base(a, g);
    if (!a.soft) {
      const bool use = dbin >= 0;
      dkeys[i] = use ? (unsigned)(base + dbin) : (unsigned)a.hist;
      f.dvals[i] = dw;
      used += use;
      continue;
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
      f.dvals[k * n + i] = val;
      used += use;
    }
  }
  count_add(&f.cnt[CNT_LIVE + (t & 1)], live);
  count_add(&f.cnt[CNT_USED + (t & 1)], used);
}

// the compaction, done by the children's last sort pass in place of its
// scatter: child s at its sorted place j goes, if j < width = min(K,
// live), into tape row `out` with its provenance, else, if live, its
// weight to drop[j - K]
struct PlaceChild {
  const Args& a;
  const Fwd& f;
  float* out;
  int live, width;
  __device__ void operator()(unsigned pos, unsigned, int s) const {
    const int j = (int)pos;
    if (j < width) {
      for (int q = 0; q < NCH; ++q)
        out[(size_t)q * a.K + j] = f.ch[(size_t)q * a.CH + s];
      out[(size_t)T_SRC * a.K + j] = __int_as_float(s);
    } else if (j < live) {
      f.drop[j - a.K] = f.ch[(size_t)F_W * a.CH + s];
    }
  }
};

// the sorted deposits of step t: each bin's first adds its run in order
__device__ void deposit_phase(const Fwd& f, int t) {
  const int used = load_shared_int(&f.cnt[CNT_USED + (t & 1)]);
  const unsigned* bins = f.sd.k[f.dpasses & 1];
  const int* order = f.sd.v[f.dpasses & 1];
  GRID_LOOP(j, used) {
    const unsigned b = bins[j];
    if (j > 0 && bins[j - 1] == b) continue;
    float acc = f.hist[b];
    for (int u = j; u < used && bins[u] == b; ++u)
      acc = acc + f.dvals[order[u]];
    f.hist[b] = acc;
  }
}

// a sum over the block of one double per virtual thread v * THREADS + tid
// of a LEDGER_THREADS-thread block, in that block's order: each virtual
// warp by shuffles, then the virtual warps' sums in order
__device__ double ledger_sum(const double* v, double* s_red) {
  constexpr int V = LEDGER_THREADS / THREADS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < V; ++q) {
    double x = v[q];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    if (lane == 0) s_red[q * SORT_WARPS + warp] = x;
  }
  __syncthreads();
  double t = 0.0;
  for (int k = 0; k < LEDGER_THREADS / 32; ++k) t += s_red[k];
  return t;
}

// one block (the last: the one a step's grid-stride loops load least):
// step t's ledgers (t < 0: the launch rays' children), the step count,
// and the step parity's counters reset for step t + 2.  Virtual thread
// q * THREADS + tid sums items q * THREADS + tid + k * LEDGER_THREADS in
// order; the loads of the four go together.
__device__ void ledger_block(const Args& a, const Fwd& f, int t,
                             double* s_red) {
  constexpr int V = LEDGER_THREADS / THREADS;
  const int n = t < 0 ? a.R : load_shared_int(&f.widths[t]);
  const int ndrop = max(0, load_shared_int(&f.cnt[CNT_LIVE + (t & 1)])
                             - a.K);
  const float* pr = f.pr[t & 1];
  double sa[V], sb[V], sd[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    sa[q] = 0.0;
    sb[q] = 0.0;
    sd[q] = 0.0;
  }
  for (int i0 = threadIdx.x; i0 < n; i0 += LEDGER_THREADS) {
    float va[V], vb[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int i = i0 + q * THREADS;
      va[q] = i < n ? pr[i] : 0.0f;
      vb[q] = i < n ? pr[n + i] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if (i0 + q * THREADS < n) {
        sa[q] += va[q];
        sb[q] += vb[q];
      }
    }
  }
  for (int i0 = threadIdx.x; i0 < ndrop; i0 += LEDGER_THREADS) {
    float vd[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int i = i0 + q * THREADS;
      vd[q] = i < ndrop ? f.drop[i] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < V; ++q)
      if (i0 + q * THREADS < ndrop) sd[q] += vd[q];
  }
  const double ta = ledger_sum(sa, s_red);
  const double tb = ledger_sum(sb, s_red);
  const double td = ledger_sum(sd, s_red);
  if (threadIdx.x == 0) {
    f.ledger[1] = f.ledger[1] + ((float)ta + (float)tb);
    f.ledger[0] = f.ledger[0] + (float)td;
    if (t >= 0 && n > 0) f.cnt[CNT_STEPS] += 1;
    f.cnt[CNT_LIVE + (t & 1)] = 0;
    f.cnt[CNT_USED + (t & 1)] = 0;
  }
}

// step t's sorts (t < 0: the launch rays'): the four passes of its n
// children, the last of which compacts them into tape row `out` (and the
// width into widths[t + 1]), and side by side the f.dpasses passes of its
// dn deposits, whose adds run in the phase after their last pass
__device__ void sort_and_compact(const Args& a, const Fwd& f, int t, int n,
                                 int dn, float* out, unsigned* bar,
                                 SortShared& sh) {
  const int live = load_shared_int(&f.cnt[CNT_LIVE + (t & 1)]);
  const int width = min(a.K, live);
  if (blockIdx.x == 0 && threadIdx.x == 0) f.widths[t + 1] = width;
  for (int p = 0; p < 4; ++p) {
    const bool dep = p < f.dpasses && dn > 0;
    sort_hist(f.sk, p & 1, n, 8 * p, &f.cnt[CNT_TICK], sh);
    if (dep) sort_hist(f.sd, p & 1, dn, 8 * p, &f.cnt[CNT_TICK + 1], sh);
    if (dn > 0 && p == f.dpasses) deposit_phase(f, t);
    grid_sync(bar);
    if (p < 3)
      sort_scatter(f.sk, p & 1, n, 8 * p, sh);
    else
      sort_scatter(f.sk, p & 1, n, 8 * p, sh,
                   PlaceChild{a, f, out, live, width});
    if (dep) sort_scatter(f.sd, p & 1, dn, 8 * p, sh);
    grid_sync(bar);
  }
  if (dn > 0 && f.dpasses == 4) {
    deposit_phase(f, t);
    grid_sync(bar);
  }
}

// the whole forward: the launch rays' children, then up to f.steps steps,
// leaving after the step whose kept wavefront is empty
__global__ void __launch_bounds__(THREADS)
split_forward_kernel(const Args a, const Fwd f) {
  __shared__ SortShared sh;
  __shared__ double s_red[LEDGER_THREADS / 32];
  unsigned* bar = reinterpret_cast<unsigned*>(f.cnt + CNT_BAR);
  const size_t row = (size_t)NT * a.K;
  init_phase(a, f);
  grid_sync(bar);
  if (a.R > 0) sort_and_compact(a, f, -1, 2 * a.R, 0, f.tape, bar, sh);
  for (int t = 0;; ++t) {
    if (blockIdx.x == gridDim.x - 1) ledger_block(a, f, t - 1, s_red);
    const int n = load_shared_int(&f.widths[t]);
    if (t >= f.steps || n == 0) break;
    const size_t r_in = f.ring ? (size_t)(t & 1) : (size_t)t;
    const size_t r_out = f.ring ? (size_t)((t + 1) & 1) : (size_t)t + 1;
    step_phase(a, f, f.tape + r_in * row, t, n);
    grid_sync(bar);
    sort_and_compact(a, f, t, 2 * n, (a.soft ? 4 : 1) * n,
                     f.tape + r_out * row, bar, sh);
  }
}

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
// step t's adjoint (splitting.py::_step_adjoint) for slot i of tape row
// `row` (n slots): its children's adjoints from lam_in (zeroed as read),
// its own into lam_out at its provenance, its contributions staged with
// their table entries as sort keys (records [0, n), cells [n, 2n),
// direction rows A, B, hop [2n, 5n))
__device__ void adjoint_slot(const Args& a, const float* row, int n, int i,
                             const float* gh, float* lam_in, float* lam_out,
                             int LC, float* c_rec, float* c_cell,
                             float* c_dirs, unsigned* keys) {
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

// split_init's adjoint (splitting.py::_init_adjoint) for launch ray i:
// cells [0, 2R) (A of ray r at r, B at R + r), direction rows [2R, 4R)
__device__ void init_adjoint_ray(const Args& a, int i, float* lam_in, int LC,
                                 float* c_cell, float* c_dirs,
                                 unsigned* keys) {
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

// ---------------------------------------------------------------------------
// the backward

// the backward's tensors and scratch
struct Bwd {
  const float* tape;     // (steps + 1, NT, K)
  const int* widths;     // (steps + 1,)
  const float* gh;       // the histogram's adjoint
  float* d_rec;          // the tables' adjoints, entry-major
  float* d_cell;
  float* d_dirs;
  int* cnt;              // NCNT counters
  float* lam;            // (2, NADJ, LC) children's adjoints, two levels
  int LC;
  float* c_rec;          // (K, 26)
  float* c_cell;         // (max(K, 2R), 26)
  float* c_dirs;         // (max(3K, 2R), 6)
  SortBuf sc;            // the contributions' sort, max(5K, 4R) pairs
  int steps, passes;
};

// where a table entry's run adds, the contributions it adds (row width,
// and the entry type's first row in the list)
struct Entry {
  float* dst;
  const float* src;
  int width, off;
};

__device__ __forceinline__ Entry entry_of(const Args& a, const Bwd& b,
                                          unsigned e, int rec_end,
                                          int cell_end) {
  Entry x;
  if (e < (unsigned)a.E) {
    x.dst = b.d_rec + (size_t)e * REC_W;
    x.src = b.c_rec;
    x.width = REC_W;
    x.off = 0;
  } else if (e < (unsigned)(a.E + a.C)) {
    x.dst = b.d_cell + (size_t)(e - a.E) * CELL_W;
    x.src = b.c_cell;
    x.width = CELL_W;
    x.off = rec_end;
  } else {
    x.dst = b.d_dirs + (size_t)(e - a.E - a.C) * DIR_W;
    x.src = b.c_dirs;
    x.width = DIR_W;
    x.off = cell_end;
  }
  return x;
}

// the run a warp adds: its entry and, in lane k, column k's sum
struct Run {
  unsigned e;
  Entry x;
  float acc;
  bool open;
};

__device__ __forceinline__ void close_run(Run& r, int lane) {
  if (r.open && lane < r.x.width) r.x.dst[lane] = r.acc;
  r.open = false;
}

// the items [lo, hi) of a window of 32 sorted contributions (lane q holds
// item q's entry e_l and list index o_l) in list order: a head (its bit in
// `heads`) closes the open run and opens its own, starting from the
// entry's sum so far.  The rows (and the heads' sums) of ADD_GROUP items
// are loaded before they are added.
__device__ void add_window(const Args& a, const Bwd& b, unsigned e_l,
                           int o_l, int lo, int hi, unsigned heads,
                           int rec_end, int cell_end, Run& run) {
  const int lane = threadIdx.x & 31;
  for (int q0 = lo; q0 < hi; q0 += ADD_GROUP) {
    float v[ADD_GROUP], d[ADD_GROUP];
    unsigned ee[ADD_GROUP];
#pragma unroll
    for (int q = 0; q < ADD_GROUP; ++q) {
      const int p = q0 + q;
      const unsigned e = __shfl_sync(FULL, e_l, p & 31);
      const int o = __shfl_sync(FULL, o_l, p & 31);
      ee[q] = e;
      v[q] = 0.0f;
      d[q] = 0.0f;
      if (p < hi) {
        const Entry x = entry_of(a, b, e, rec_end, cell_end);
        if (lane < x.width) {
          v[q] = x.src[(size_t)(o - x.off) * x.width + lane];
          if ((heads >> p) & 1u) d[q] = x.dst[lane];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ADD_GROUP; ++q) {
      const int p = q0 + q;
      if (p < hi) {
        if ((heads >> p) & 1u) {
          close_run(run, lane);
          run.e = ee[q];
          run.x = entry_of(a, b, ee[q], rec_end, cell_end);
          run.acc = d[q];
          run.open = true;
        }
        run.acc = run.acc + v[q];
      }
    }
  }
}

// the rest of an open run through the next window (whose first `hi` items
// are the run's: lane q holds item q's list index o_l): each lane loads
// its column of the hi rows, then adds them in order
__device__ __forceinline__ void add_run_window(int o_l, int hi, Run& run) {
  const int lane = threadIdx.x & 31;
  float v[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int o = __shfl_sync(FULL, o_l, q);
    v[q] = q < hi && lane < run.x.width
               ? run.x.src[(size_t)(o - run.x.off) * run.x.width + lane]
               : 0.0f;
  }
#pragma unroll
  for (int q = 0; q < 32; ++q)
    if (q < hi) run.acc = run.acc + v[q];
}

// the row of an open run's item (entry e, list index o) into L1, ahead of
// its add; items of other entries are skipped
__device__ __forceinline__ void prefetch_row(const Run& run, unsigned e,
                                             int o) {
  if (e != run.e) return;
  const float* r = run.x.src + (size_t)(o - run.x.off) * run.x.width;
  asm volatile("prefetch.global.L1 [%0];" ::"l"(r));
  asm volatile("prefetch.global.L1 [%0];" ::"l"(r + run.x.width - 1));
}

// the sorted contributions of step t (n slots; t < 0: the launch rays'),
// `items` of them: a warp takes 32 and adds every run that starts among
// them to its end, each lane its column, in list order.  A run that goes
// on past the window is followed window by window, its entries and list
// indices loaded four windows ahead and its rows prefetched two ahead.
__device__ void table_add_phase(const Args& a, const Bwd& b, int t, int n,
                                int items) {
  const int lane = threadIdx.x & 31;
  const unsigned* ents = b.sc.k[b.passes & 1];
  const int* order = b.sc.v[b.passes & 1];
  const int rec_end = n;
  const int cell_end = t < 0 ? 2 * a.R : 2 * n;
  const int stride = gridDim.x * THREADS;
  for (int j0 = blockIdx.x * THREADS + (threadIdx.x & ~31); j0 < items;
       j0 += stride) {
    const int j = j0 + lane;
    const unsigned e_l = j < items ? ents[j] : NO_KEY;
    const int o_l = j < items ? order[j] : 0;
    unsigned prev = __shfl_up_sync(FULL, e_l, 1);
    if (lane == 0) prev = j0 > 0 ? ents[j0 - 1] : NO_KEY;
    const unsigned heads = __ballot_sync(FULL, j < items && e_l != prev);
    if (!heads) continue;
    // the next window, in case the last run goes on past this one
    int jw = j0 + 32 + lane;
    unsigned ew = jw < items ? ents[jw] : NO_KEY;
    int ow = jw < items ? order[jw] : 0;
    Run run;
    run.open = false;
    add_window(a, b, e_l, o_l, __ffs(heads) - 1, min(32, items - j0), heads,
               rec_end, cell_end, run);
    unsigned same = __ballot_sync(FULL, jw < items && ew == run.e);
    if (same) {
      unsigned e1, e2, e3, e4;
      int o1, o2, o3, o4;
#define AHEAD(e, o, k)                                          \
  do {                                                          \
    const int j_ = jw + 32 * (k);                               \
    e = j_ < items ? ents[j_] : NO_KEY;                         \
    o = j_ < items ? order[j_] : 0;                             \
  } while (0)
      AHEAD(e1, o1, 1);
      AHEAD(e2, o2, 2);
      AHEAD(e3, o3, 3);
      AHEAD(e4, o4, 4);
      prefetch_row(run, ew, ow);
      prefetch_row(run, e1, o1);
      for (;;) {
        if (same != FULL) {
          add_run_window(ow, __ffs(~same) - 1, run);
          break;
        }
        prefetch_row(run, e2, o2);
        unsigned e5;
        int o5;
        AHEAD(e5, o5, 5);
        add_run_window(ow, 32, run);
        jw += 32;
        ew = e1, ow = o1, e1 = e2, o1 = o2, e2 = e3, o2 = o3;
        e3 = e4, o3 = o4, e4 = e5, o4 = o5;
        same = __ballot_sync(FULL, jw < items && ew == run.e);
        if (!same) break;
      }
#undef AHEAD
    }
    close_run(run, lane);
  }
}

// the passes of one sort of n pairs
__device__ void sort_passes(const SortBuf& s, int n, int passes, int* tick,
                            unsigned* bar, SortShared& sh) {
  for (int p = 0; p < passes; ++p) {
    sort_hist(s, p & 1, n, 8 * p, tick, sh);
    grid_sync(bar);
    sort_scatter(s, p & 1, n, 8 * p, sh);
    grid_sync(bar);
  }
}

// the whole backward: the adjoints' levels zeroed, the steps from the last
// to the first, then the launch rays.  Two blocks of THREADS a SM: the
// adjoint needs about 120 registers.
__global__ void __launch_bounds__(THREADS, 2)
split_backward_kernel(const Args a, const Bwd b) {
  __shared__ SortShared sh;
  unsigned* bar = reinterpret_cast<unsigned*>(b.cnt + CNT_BAR);
  const size_t row = (size_t)NT * a.K;
  const size_t level = (size_t)NADJ * b.LC;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < 2 * level;
       i += (size_t)gridDim.x * THREADS)
    b.lam[i] = 0.0f;
  grid_sync(bar);
  for (int t = b.steps - 1; t >= 0; --t) {
    const int n = b.widths[t];
    if (n == 0) continue;
    const float* rt = b.tape + (size_t)t * row;
    float* lam_in = b.lam + (size_t)(t & 1) * level;
    float* lam_out = b.lam + (size_t)((t + 1) & 1) * level;
    GRID_LOOP(i, n)
      adjoint_slot(a, rt, n, i, b.gh, lam_in, lam_out, b.LC, b.c_rec,
                   b.c_cell, b.c_dirs, b.sc.k[0]);
    grid_sync(bar);
    sort_passes(b.sc, 5 * n, b.passes, &b.cnt[CNT_TICK], bar, sh);
    table_add_phase(a, b, t, n, 5 * n);
    grid_sync(bar);
  }
  if (a.R > 0) {
    GRID_LOOP(i, a.R)
      init_adjoint_ray(a, i, b.lam + level, b.LC, b.c_cell, b.c_dirs,
                       b.sc.k[0]);
    grid_sync(bar);
    sort_passes(b.sc, 4 * a.R, b.passes, &b.cnt[CNT_TICK], bar, sh);
    table_add_phase(a, b, -1, 0, 4 * a.R);
  }
}

// ---------------------------------------------------------------------------
// scratch layouts and the launch

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

// the blocks of a step's widest phase: the forward's 2K children, the
// backward's 5K contributions (a warp takes 32); the grid is at most that
int fwd_blocks(const Args& a) {
  return (int)((2LL * a.K + THREADS - 1) / THREADS);
}

int bwd_blocks(const Args& a) {
  return (int)((5LL * a.K + THREADS - 1) / THREADS);
}

size_t fwd_scratch(const Args& a, char* base, Fwd& f) {
  const size_t DN = (size_t)(a.soft ? 4 : 1) * a.K;
  const size_t rows = (size_t)fwd_blocks(a) * RADIX;
  Carve c{base, 0};
  f.ch = c.take<float>((size_t)NCH * a.CH);
  for (int b = 0; b < 2; ++b) {
    f.sk.k[b] = c.take<unsigned>(a.CH);
    f.sk.v[b] = c.take<int>(a.CH);
    f.sd.k[b] = c.take<unsigned>(DN);
    f.sd.v[b] = c.take<int>(DN);
    f.pr[b] = c.take<float>(a.CH);
  }
  f.sk.agg = c.take<unsigned>(rows);
  f.sd.agg = c.take<unsigned>(rows);
  f.sk.off = c.take<unsigned>(RADIX);
  f.sd.off = c.take<unsigned>(RADIX);
  f.drop = c.take<float>(a.CH);
  f.dvals = c.take<float>(DN);
  return c.at;
}

size_t bwd_scratch(const Args& a, char* base, Bwd& s) {
  s.LC = a.CH;
  const int NI = 5 * a.K > 4 * a.R ? 5 * a.K : 4 * a.R;
  Carve c{base, 0};
  s.lam = c.take<float>((size_t)2 * NADJ * s.LC);
  s.c_rec = c.take<float>((size_t)a.K * REC_W);
  s.c_cell = c.take<float>((size_t)(a.K > 2 * a.R ? a.K : 2 * a.R) * CELL_W);
  s.c_dirs = c.take<float>((size_t)(3 * a.K > 2 * a.R ? 3 * a.K : 2 * a.R)
                           * DIR_W);
  for (int b = 0; b < 2; ++b) {
    s.sc.k[b] = c.take<unsigned>(NI);
    s.sc.v[b] = c.take<int>(NI);
  }
  s.sc.agg = c.take<unsigned>((size_t)bwd_blocks(a) * RADIX);
  s.sc.off = c.take<unsigned>(RADIX);
  return c.at;
}

bool params_ok(const int* p) {
  return p[P_R] >= 0 && p[P_K] > 0 && p[P_C] > 0
         && p[P_R2] == 2 * (1 + p[P_NUM_FC] + p[P_NUM_OC])
         && p[P_E] == p[P_C] * p[P_R2] && p[P_NUM_FC] >= 1
         && p[P_NUM_OC] >= 1 && p[P_NY] >= 2 && p[P_NX] >= 2
         && p[P_M] >= 1 && p[P_N] >= 1 && p[P_GRID_N] >= 1
         && p[P_HIST] > 0 && p[P_E_IC] >= 0 && p[P_E_R1] >= 0
         && p[P_E_R2] >= 0 && p[P_E_HULL] >= 0 && p[P_STEPS] >= 0
         // keys: a bin (or hist) and the table entries in 32 bits, children
         // indices in 31, 5K contributions in an int
         && (long long)p[P_E] + 5LL * p[P_C] < (1LL << 31)
         && 2LL * (p[P_R] > p[P_K] ? p[P_R] : p[P_K]) < (1LL << 30)
         && 5LL * p[P_K] < (1LL << 31);
}

// the cooperative launch of `fn` on min(blocks, resident blocks per SM x
// SMs) blocks of THREADS; info: kernels launched, the grid, resident
// blocks per SM
int launch(const void* fn, int blocks, void** args, cudaStream_t st,
           int* info) {
  int dev, sms, per_sm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = max(1, min(blocks, per_sm * sms));
  info[1] = grid;
  info[2] = per_sm;
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS), args, 0,
                                  st);
  if (e != cudaSuccess) return (int)e;
  info[0] = 1;
  return 0;
}

}  // namespace

// Scratch bytes of split_trace_forward (backward = 0) or
// split_trace_backward (1) with the int parameters p.
extern "C" size_t split_trace_scratch_bytes(const int* p, int backward) {
  const Args a = make_args(p, 0.0f, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr);
  if (backward) {
    Bwd s;
    return bwd_scratch(a, nullptr, s);
  }
  Fwd s;
  return fwd_scratch(a, nullptr, s);
}

// The forward on `stream`, one kernel: the launch rays' children into tape
// row 0, then up to p[P_STEPS] steps, step t sweeping row t into row t + 1
// (p[P_RING]: rows t & 1 and (t + 1) & 1), its deposits into hist and its
// ledgers into ledger (trunc, pruned); it stops after the first step that
// keeps no slot.  counters: int[NCNT] then widths int[steps + 1], all zero
// before the call.  info: int[3] (kernels launched, grid, resident blocks
// per SM).  Returns a cudaError_t code (0: launched).
extern "C" int split_trace_forward(
    const int* p, float thr, const void* rec, const void* cell,
    const void* dirs, const void* geom, const void* grid, const void* rays,
    const void* cid, void* tape, void* widths, void* hist, void* ledger,
    void* counters, void* scratch, int* info, void* stream) {
  info[0] = 0;
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  Args a = make_args(p, thr, rec, cell, dirs, geom, grid, rays, cid);
  Fwd f;
  fwd_scratch(a, static_cast<char*>(scratch), f);
  f.tape = static_cast<float*>(tape);
  f.widths = static_cast<int*>(widths);
  f.hist = static_cast<float*>(hist);
  f.ledger = static_cast<float*>(ledger);
  f.cnt = static_cast<int*>(counters);
  f.steps = p[P_STEPS];
  f.ring = p[P_RING];
  f.dpasses = (bit_length((unsigned)a.hist) + 7) / 8;
  void* args[] = {&a, &f};
  return launch(reinterpret_cast<const void*>(split_forward_kernel),
                fwd_blocks(a), args, static_cast<cudaStream_t>(stream),
                info);
}

// The backward on `stream`, one kernel, over the p[P_STEPS] steps of a
// forward's tape (rows 0 .. p[P_STEPS], widths alike): the tables'
// adjoints, entry-major as the tables, added into d_rec, d_cell, d_dirs
// (zero before the call).  counters: int[NCNT], zero.  info as the
// forward's.  Returns a cudaError_t code (0: launched).
extern "C" int split_trace_backward(
    const int* p, const void* rec, const void* cell, const void* dirs,
    const void* geom, const void* grid, const void* rays, const void* cid,
    const void* tape, const void* widths, const void* grad_hist,
    void* d_rec, void* d_cell, void* d_dirs, void* counters, void* scratch,
    int* info, void* stream) {
  info[0] = 0;
  if (!params_ok(p)) return (int)cudaErrorInvalidValue;
  Args a = make_args(p, 0.0f, rec, cell, dirs, geom, grid, rays, cid);
  Bwd b;
  bwd_scratch(a, static_cast<char*>(scratch), b);
  b.tape = static_cast<const float*>(tape);
  b.widths = static_cast<const int*>(widths);
  b.gh = static_cast<const float*>(grad_hist);
  b.d_rec = static_cast<float*>(d_rec);
  b.d_cell = static_cast<float*>(d_cell);
  b.d_dirs = static_cast<float*>(d_dirs);
  b.cnt = static_cast<int*>(counters);
  b.steps = p[P_STEPS];
  b.passes = (bit_length((unsigned)(a.E + 5 * a.C)) + 7) / 8;
  void* args[] = {&a, &b};
  return launch(reinterpret_cast<const void*>(split_backward_kernel),
                bwd_blocks(a), args, static_cast<cudaStream_t>(stream),
                info);
}

extern "C" const char* split_trace_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
