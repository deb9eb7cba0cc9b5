// The exact per-cell splitting engine for NVIDIA Hopper (sm_90a): one launch
// traces every wavefront of a chunk of (lambda, FoV) cells to the end.
//
// Replaces no Pallas kernel.  The JAX package runs its per-cell engine
// (engine/splitting.py::make_splitting_cells_fn, fast=False) as jnp under a
// jax.lax.while_loop on its device; the port's plain PyTorch version
// (engine/splitting.py::split_cells_reference) runs that loop eagerly from
// the host: about 300 operations and two reads of the device per step.
// This kernel runs the whole loop on the card, so a chunk is one launch and
// no step reads the device from the host.
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
// Design.  A cell runs on a cluster of Q blocks of 256 threads, Q = 1, 2
// or 4: the wrapper picks the largest Q whose chunk of C cells fills at
// most two waves of the card (splitting.cluster_size: 4 for the 128-cell
// --tail-exact chunk, 2 for simulate --engine splitting's 256 cells, 1 for
// the CLI's 512), so a small chunk's cells spread their passes over
// several SMs.  A step sweeps its slots in passes of W = 256 Q: thread t
// of block r steps slot c0 + 256 r + t, its 11 fields copied into shared
// memory (cp.async) while the pass before ran.  The region tests come from
// the region grid refined where it is open (trace_vector.region_subgrids),
// the rest by the whole warp, an edge a lane, the hull and r2 only inside
// r1 (regions_warp, step_common.cuh): bit for bit what the step reads of
// the exact test, which one lane walked over its ~100 edges while the warp
// waited.  A pass has one wait: each warp sends its (A live, B live,
// deposit) counts to every block of the cluster (st.async into the other
// blocks' shared memory, counted on their mbarriers; a block barrier when
// Q = 1), then waits for the cluster's, so each thread knows its children's
// places: A children go to the next A buffer, B children to the next side
// buffer.  The next step reads slot i < run_a from the A buffer and the
// rest from the side buffer (two pairs of buffers, 11 fields of K slots
// each, 176 * K bytes a cell): no copy.  The cell's (ny, nx) tile is dealt
// out over the cluster's warps (bin b to warp b % (8 Q), in shared memory);
// each deposit goes, in slot order, to every block's list, and one pass
// later each warp walks the list 32 deposits at a time, groups its own
// bins' deposits with __match_any_sync and adds each group in lane order
// as a chain in registers (the weights shuffled ahead): every bin receives
// its adds in the plain version's order (earlier steps and passes first,
// then slot order), with no float atomics, no sort and no barrier.  The
// pruned and truncated weights are summed per step in float64 in an order
// fixed by the slot index alone (32 slots by a warp's butterfly, 32 such
// units by another on block 0, these groups in order), so a cell's ledgers
// do not depend on Q or on the other cells of its launch; they are rounded
// once a step and added to the float32 ledgers as the plain version adds
// them.  A step ends with a cluster barrier (release and acquire), after
// which the next step reads the children.
//
// What bounds it on an H100: the bytes of the wavefront (each stepped slot
// read once, 44 B, and written once as a child, 44 B) over the sum of the
// widths of the steps, each cell's records (staged in shared memory once)
// and tile once; its float32 work is about 200 operations a slot.  It runs
// 3.5-5 times that bound: a slot's step is one thread's dependent chain, so
// a pass costs about 3 us whatever its width, a cell's time is its steps
// times its passes, and the widest cell of a chunk sets the launch's time.
// 256 threads at up to 128 registers (no spills): two blocks an SM.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "split_common.cuh"

// Phase marks, empty here: tools/split_cells_phases.py builds a copy that
// defines them, timing block 0's phases with %globaltimer (each mark ends
// the phase named in this list, after a barrier) and counting its deposits.
// SC_MARK phases: setup compute exchange store deposits step_end finish
#ifndef SC_MARK
#define SC_MARK(k)
#define SC_COUNT(k, v)
#define SC_MAX(k, v)
#endif

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 2;
constexpr int GROUP = 1024;            // slots of a ledger group (32 units)
// a pass's counts, deposits and barrier, and a ledger group, take one of
// two slots: a block sends the counts of pass k + 1 after settling pass
// k - 1, and every block has sent those of pass k before it gets there
constexpr int SLOTS = 2;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const float* rec;      // (26, C * R2) component-major
  const float* cell;     // (26, C)
  const float* dirs;     // (6, C * 4)
  const float* geom;     // NG scalars, then the four half-plane packs
  const int16_t* fine;   // (grid_n, grid_n) region codes or subgrid rows
  const uint8_t* sub_codes;   // (M, sub, sub) subcell region codes
  const float* seeds;    // (6, P), or (6, C, P) with per_cell_seeds
  float* buf;            // (C, 4, NF, K) wavefront scratch
  float* tiles;          // (C, ny * nx)
  float* trunc;          // (C,)
  float* pruned;         // (C,)
  int* peak;             // (C,)
  int* steps;            // (C,)
  long long* work;       // (C,) slots stepped, summed over the steps
  int C, P, K, R2, num_fc, num_oc, ny, nx, max_steps, per_cell_seeds, circle;
  int grid_n, sub, e_ic, e_r1, e_r2, e_hull;
  float thr;
};

// the cluster's barrier (release and acquire), or the block's when Q = 1
template <int Q>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (Q == 1) __syncthreads();
  else cg::this_cluster().sync();
}

// The pass's exchange between the blocks of a cluster: 8-byte st.async
// stores into another block's shared memory, each counted (complete_tx) on
// that block's mbarrier, which its thread 0 arms with the bytes it expects;
// a block waits on its own barrier, with no fence and no cluster barrier.

// the shared::cluster address of p in block `rank`'s memory
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void send8(const void* p, int rank,
                                      unsigned long long v, const void* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];" ::"r"(cluster_addr(p, rank)),
      "l"(v), "r"(cluster_addr(bar, rank))
      : "memory");
}

__device__ __forceinline__ void bar_init(void* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(bar)),
               "r"(bytes)
               : "memory");
}

// a wait on the barrier's phase `parity`; a wait past ~2^22 polls (far
// beyond any pass) traps rather than hang the card
__device__ __forceinline__ void bar_wait(void* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls > (1u << 22)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"((unsigned)__cvta_generic_to_shared(bar)), "r"(parity)
        : "memory");
  }
}

// a slot's 11 fields, copied from device memory into a shared row of
// THREADS floats a field (cp.async: the copy runs behind the pass before)
__device__ __forceinline__ void fetch_ray(float* dst, const float* src, int K,
                                          int i) {
  for (int f = 0; f < NF; ++f) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + f * THREADS);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src + (size_t)f * K + i) : "memory");
  }
}

__device__ __forceinline__ Ray shared_ray(const float* s) {
  Ray r;
  r.x = s[F_X * THREADS];
  r.y = s[F_Y * THREADS];
  r.ter = s[F_TER * THREADS];
  r.tei = s[F_TEI * THREADS];
  r.tmr = s[F_TMR * THREADS];
  r.tmi = s[F_TMI * THREADS];
  r.cos = s[F_COS * THREADS];
  r.gx = s[F_GX * THREADS];
  r.gy = s[F_GY * THREADS];
  r.st = __float_as_int(s[F_ST * THREADS]);
  r.w = s[F_W * THREADS];
  return r;
}

__device__ __forceinline__ int next_slot(int k) {
  return k == SLOTS - 1 ? 0 : k + 1;
}

__device__ __forceinline__ int prev_slot(int k) {
  return k == 0 ? SLOTS - 1 : k - 1;
}

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

template <int Q>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
split_cells_kernel(const Args a) {
  constexpr int OWN = Q * WARPS;       // tile owners: the cluster's warps
  constexpr int W = Q * THREADS;       // slots of a pass
  extern __shared__ __align__(16) float smem[];
  // [pass slot][warp of the cluster]: the warp's A | B << 16 and D counts
  __shared__ __align__(8) unsigned long long s_cnt[SLOTS][OWN];
  __shared__ double s_unit[SLOTS][2][32];  // [group slot][pruned, dropped]
  __shared__ __align__(8) unsigned long long s_bar[SLOTS];   // [pass slot]
  // block 0's thread 0: the step's float64 sums so far (pruned, dropped)
  // and the float32 ledgers (pruned, truncated)
  __shared__ double s_sums[2];
  __shared__ float s_ledger[2];
  const int r = Q == 1 ? 0 : (int)cg::this_cluster().block_rank();
  const int c = blockIdx.x / Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int me = r * WARPS + warp;
  const int nb = a.ny * a.nx;
  const int nloc = (nb + OWN - 1) / OWN * WARPS;   // this block's bins
  const int ng = NG + 3 * (a.e_ic + a.e_r1 + a.e_r2 + a.e_hull);

  float* s_tile = smem;
  float* s_rec = s_tile + nloc;
  float* s_cell = s_rec + REC_W * a.R2;
  float* s_dirs = s_cell + CELL_W;
  float* s_geom = s_dirs + 4 * DIR_W;
  // [pass slot][W]: a pass's deposits in slot order, (bin, weight bits)
  unsigned long long* s_dep = reinterpret_cast<unsigned long long*>(
      s_geom + ((ng + 1) & ~1));
  // [2][NF][THREADS]: the fetched slots of a pass, at this thread's column
  float* s_fetch = reinterpret_cast<float*>(s_dep + SLOTS * W) + tid;

  SC_MARK(0);
  for (int k = tid; k < nloc; k += THREADS) s_tile[k] = 0.0f;
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
  if (tid == 0) {
    s_sums[0] = s_sums[1] = 0.0;
    s_ledger[0] = s_ledger[1] = 0.0f;
    if (Q > 1) {
      for (int k = 0; k < SLOTS; ++k) bar_init(&s_bar[k]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  // every block of the cluster runs before any writes another's memory
  cluster_sync<Q>();
  SC_MARK(1);

  Cell cc;
  cc.rec = s_rec;
  cc.cell = s_cell;
  cc.dirs = s_dirs;
  cc.g = s_geom;
  cc.ic_hp = s_geom + NG;
  cc.r1_hp = cc.ic_hp + 3 * a.e_ic;
  cc.r2_hp = cc.r1_hp + 3 * a.e_r1;
  cc.hull_hp = cc.r2_hp + 3 * a.e_r2;
  cc.grid = nullptr;   // the region codes come from a.fine
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
  float* base = a.buf + (size_t)c * 4 * NF * K;
  const float* seeds = a.seeds + (a.per_cell_seeds ? (size_t)c * a.P : 0);
  const size_t seed_stride = (size_t)a.P * (a.per_cell_seeds ? a.C : 1);

  // The pass before, settled one pass late (every thread holds the same):
  // its deposits, the ledger group it completes, whether it ends its step.
  bool pv_valid = false, pv_end = false;
  int pv_dep = 0, pv_group = -1, pv_units = 0, pv_lo = 0, pv_hi = 0;
  int pv_side = 0;
  // its deposits (in s_dep[slot]): each warp adds its own bins' in slot
  // order; block 0's warp 0 folds its ledger group and, at a step's end,
  // the step's sums into the ledgers
  auto settle = [&](int dpar) {
    const unsigned long long* dep = s_dep + dpar * W;
    for (int j0 = 0; j0 < pv_dep; j0 += 32) {
      const int j = j0 + lane;
      const unsigned long long d = j < pv_dep ? dep[j] : ~0ull;
      const int b = (int)(unsigned)d;
      const bool mine = b >= 0 && b % OWN == me;
      if (!__any_sync(FULL, mine)) continue;
      const float w = __uint_as_float((unsigned)(d >> 32));
      const unsigned grp = __match_any_sync(FULL, mine ? b : -1 - lane);
      const bool lead = mine && __ffs(grp) - 1 == lane;
      const int l = (b / OWN) * WARPS + warp;
      SC_COUNT(3, lead ? 1 : 0);
      SC_MAX(4, lead ? __popc(grp) : 0);
      if (__any_sync(FULL, mine && (grp & (grp - 1)) != 0)) {
        // a bin with several deposits here: its leader adds them in lane
        // order, the weights shuffled ahead into registers
        float v[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) v[k] = __shfl_sync(FULL, w, k);
        if (lead) {
          float acc = s_tile[l];
#pragma unroll
          for (int k = 0; k < 32; ++k)
            if ((grp >> k) & 1u) acc = acc + v[k];
          s_tile[l] = acc;
        }
      } else if (mine) {
        s_tile[l] = s_tile[l] + w;
      }
      __syncwarp();
    }
    if (r == 0 && warp == 0) {
      if (pv_group >= 0) {
        const bool in = lane < pv_units;
        const double gp = warp_sum(in ? s_unit[pv_group][0][lane] : 0.0);
        const double ud = in ? s_unit[pv_group][1][lane] : 0.0;
        const double gd = __any_sync(FULL, ud != 0.0) ? warp_sum(ud) : 0.0;
        if (lane == 0) {
          s_sums[0] += gp;
          s_sums[1] += gd;
        }
      }
      if (pv_end) {
        // the B children past K slots once the A children are placed
        const float* side = base + (size_t)pv_side * NF * K + F_W * K;
        double cut = 0.0;
        for (int p = pv_lo + lane; p < pv_hi; p += 32) cut += side[p];
        cut = warp_sum(cut);
        if (lane == 0) {
          s_ledger[0] = s_ledger[0] + (float)s_sums[0];
          s_ledger[1] = s_ledger[1] + (float)(s_sums[1] + cut);
          s_sums[0] = s_sums[1] = 0.0;
        }
      }
    }
  };
  // thread 0 arms its block's barrier of a pass: the cluster's counts of
  // the pass, the deposits and (block 0) the ledger units of the pass before
  auto arm = [&](int bpar, bool counts) {
    if (Q > 1 && tid == 0)
      bar_expect(&s_bar[bpar],
                 (counts ? 8u * OWN : 0u) + 8u * (unsigned)pv_dep
                     + (r == 0 && pv_valid ? 16u * OWN : 0u));
  };

  int peak = 0, it = 0;
  long long work = 0;
  int n = a.P;       // the width being swept (the seeds, then each step's)
  int split = 0;     // slots below come from the A buffer, the rest the side
  int pair = -1;     // the buffer pair being swept (-1: the seeds)
  int par = 0;       // the pass's slot (counts, deposits, barriers)
  unsigned phase = 0;   // the next phase of each barrier, a bit a slot
  int gseq = 0;      // ledger groups begun before this step
  while (true) {
    const int wp = pair == 0 ? 1 : 0;
    float* dst_a = base + (size_t)wp * NF * K;
    float* dst_s = base + (size_t)(2 + wp) * NF * K;
    const float* src_a = base + (size_t)max(pair, 0) * NF * K;
    const float* src_s = base + (size_t)(2 + max(pair, 0)) * NF * K;
    int run_a = 0, run_b = 0;
    // slot j of the step into fetch buffer k, one copy group a pass
    auto fetch = [&](int j, int k) {
      if (pair >= 0 && j < n)
        fetch_ray(s_fetch + k * NF * THREADS, j < split ? src_a : src_s, K,
                  j < split ? j : j - split);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };
    // The pass at c0 (fetch buffer fb, slot pp) stepped: this thread's
    // slot, the warp's pruned weight and its counts, which go to every
    // block (counted on its barrier of the pass).
    auto step_pass = [&](int c0, int fb, int pp, Ray& ca, Ray& cb,
                         int& dbin, float& dw, unsigned& ma, unsigned& mb,
                         unsigned& md, double& pr) {
      const int i = c0 + r * THREADS + tid;
      // the next pass's slot, copied while this one is stepped
      fetch(i + W, fb ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      dbin = -1;
      dw = 0.0f;
      pr = 0.0;
      bool la = false, lb = false;
      if (pair < 0) {
        if (i < n) {
          float s[6], pa, pb;
          for (int f = 0; f < 6; ++f) s[f] = seeds[f * seed_stride + i];
          init_children(cc, s, ca, cb, pa, pb);
          pr = (double)pa + (double)pb;
          la = ca.st < DEAD;
          lb = cb.st < DEAD;
        }
      } else {
        // the region tests by the whole warp, then the slot's step
        const Ray in = shared_ray(s_fetch + fb * NF * THREADS);
        bool r1, hull, r2;
        regions_warp(cc, a.fine, a.sub_codes, a.sub, in.x, in.y, i < n, r1,
                     hull, r2);
        if (i < n) {
          float pa, pb;
          step_children_in(cc, in, r1, hull, r2, ca, cb, dbin, dw, pa, pb);
          pr = (double)pa + (double)pb;
          la = ca.st < DEAD;
          lb = cb.st < DEAD;
        }
      }
      ma = __ballot_sync(FULL, la);
      mb = __ballot_sync(FULL, lb);
      md = __ballot_sync(FULL, dbin >= 0);
      if (lane == 0) {
        const unsigned long long t =
            (unsigned)(__popc(ma) | (__popc(mb) << 16))
            | ((unsigned long long)__popc(md) << 32);
        if constexpr (Q == 1) s_cnt[pp][me] = t;
        else
          for (int q = 0; q < Q; ++q) send8(&s_cnt[pp][me], q, t, &s_bar[pp]);
      }
      // the warp's pruned weight, summed while the counts travel
      if (__any_sync(FULL, pr != 0.0)) pr = warp_sum(pr);
    };
    // The pass at c0 placed, once the cluster's counts are in s_cnt[par]:
    // this thread's children to their places, the deposits to every block
    // and the ledger units to block 0, counted on the next pass's barrier;
    // then the pass is the one to settle.
    auto place = [&](int c0, const Ray& ca, const Ray& cb, int dbin,
                     float dw, unsigned ma, unsigned mb, unsigned md,
                     double pr) {
      const unsigned long long wv = lane < OWN ? s_cnt[par][lane] : 0ull;
      const unsigned wab = (unsigned)wv, wd = (unsigned)(wv >> 32);
      const unsigned pre_ab = __reduce_add_sync(FULL, lane < me ? wab : 0u);
      const unsigned pre_d = __reduce_add_sync(FULL, lane < me ? wd : 0u);
      const unsigned tot_ab = __reduce_add_sync(FULL, wab);
      const int tot_a = (int)(tot_ab & 0xFFFFu), tot_b = (int)(tot_ab >> 16);
      const int tot_d = (int)__reduce_add_sync(FULL, wd);
      const unsigned lt = (1u << lane) - 1u;
      double dr = 0.0;
      if ((ma >> lane) & 1u) {
        const int p = run_a + (int)(pre_ab & 0xFFFFu) + __popc(ma & lt);
        if (p < K) store_ray(dst_a, K, p, ca);
        else dr += ca.w;
      }
      if ((mb >> lane) & 1u) {
        const int p = run_b + (int)(pre_ab >> 16) + __popc(mb & lt);
        if (p < K) store_ray(dst_s, K, p, cb);
        else dr += cb.w;
      }
      if ((md >> lane) & 1u) {
        const int p = par * W + (int)pre_d + __popc(md & lt);
        const unsigned long long d =
            (unsigned)dbin | ((unsigned long long)__float_as_uint(dw) << 32);
        if constexpr (Q == 1) s_dep[p] = d;
        else
          for (int q = 0; q < Q; ++q)
            send8(&s_dep[p], q, d, &s_bar[next_slot(par)]);
      }
      if (__any_sync(FULL, dr != 0.0)) dr = warp_sum(dr);
      // the warp's 32 slots are unit (i / 32) % 32 of ledger group i / 1024
      const int gpar = (gseq + c0 / GROUP) % SLOTS;
      if (lane == 0) {
        const int u = ((c0 + r * THREADS + warp * 32) >> 5) & 31;
        if constexpr (Q == 1) {
          s_unit[gpar][0][u] = pr;
          s_unit[gpar][1][u] = dr;
        } else {
          send8(&s_unit[gpar][0][u], 0, __double_as_longlong(pr),
                &s_bar[next_slot(par)]);
          send8(&s_unit[gpar][1][u], 0, __double_as_longlong(dr),
                &s_bar[next_slot(par)]);
        }
      }
      run_a += tot_a;
      run_b += tot_b;
      const bool last = c0 + W >= n;
      if (last) peak = max(peak, run_a + run_b);
      if (tid == 0) {
        SC_COUNT(0, r == 0 ? tot_d : 0);
        SC_COUNT(1, r == 0 ? 1 : 0);
        SC_COUNT(2, r == 0 && tot_d > 0 ? 1 : 0);
      }
      SC_MARK(4);
      if (pv_valid) settle(prev_slot(par));
      SC_MARK(5);
      pv_valid = true;
      pv_dep = tot_d;
      pv_group = last || (c0 + W) % GROUP == 0 ? gpar : -1;
      pv_units = min(32, (n - (c0 / GROUP) * GROUP + 31) >> 5);
      pv_end = last;
      pv_lo = max(0, K - run_a);
      pv_hi = min(run_b, K);
      pv_side = 2 + wp;
    };
    fetch(r * THREADS + tid, 0);
    for (int c0 = 0, fb = 0; c0 < n; c0 += W, fb ^= 1) {
      Ray ca, cb;
      int dbin;
      float dw;
      unsigned ma, mb, md;
      double pr;
      step_pass(c0, fb, par, ca, cb, dbin, dw, ma, mb, md, pr);
      arm(par, true);
      SC_MARK(2);
      if constexpr (Q == 1) __syncthreads();
      else bar_wait(&s_bar[par], (phase >> par) & 1u);
      phase ^= 1u << par;
      SC_MARK(3);
      place(c0, ca, cb, dbin, dw, ma, mb, md, pr);
      par = next_slot(par);
    }
    if (pair >= 0) {
      work += n;
      ++it;
    }
    gseq += (n + GROUP - 1) / GROUP;
    pair = pair == 0 ? 1 : 0;
    split = min(run_a, K);
    n = min(K, run_a + run_b);
    // the step's children before the next step reads them: the cluster
    // barrier's release and acquire order them at cluster scope
    cluster_sync<Q>();
    SC_MARK(6);
    if (n == 0 || it >= a.max_steps) break;
  }
  // the last pass: its deposits and units, then its settling
  if (pv_valid) {
    arm(par, false);
    if constexpr (Q == 1) __syncthreads();
    else bar_wait(&s_bar[par], (phase >> par) & 1u);
    settle(prev_slot(par));
  }
  // every block's deposits are in before any leaves the cluster
  cluster_sync<Q>();
  SC_COUNT(5, tid == 0 && r == 0 ? Q : 0);

  float* tile = a.tiles + (size_t)c * nb;
  for (int k = tid; k < nloc; k += THREADS) {
    const int b = (k / WARPS) * OWN + r * WARPS + k % WARPS;
    if (b < nb) tile[b] = s_tile[k];
  }
  if (r == 0 && tid == 0) {
    a.trunc[c] = s_ledger[1];
    a.pruned[c] = s_ledger[0];
    a.peak[c] = peak;
    a.steps[c] = it;
    a.work[c] = work;
  }
  SC_MARK(7);
}

size_t shared_bytes(int Q, int ny, int nx, int R2, int e_total) {
  const int own = Q * WARPS;
  const size_t nloc = (size_t)((ny * nx + own - 1) / own) * WARPS;
  const size_t ng = NG + 3 * (size_t)e_total;
  return sizeof(float) * (nloc + REC_W * R2 + CELL_W + 4 * DIR_W
                          + ((ng + 1) & ~(size_t)1))
         + sizeof(unsigned long long) * SLOTS * (size_t)Q * THREADS
         + sizeof(float) * 2 * NF * THREADS;
}

template <int Q>
cudaError_t prepare(size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      split_cells_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  return err;
}

template <int Q>
cudaLaunchConfig_t config(int C, size_t smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(C * Q));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// at cluster size Q: blocks per SM, clusters resident on the whole card,
// the dynamic shared bytes, registers and local bytes of a thread
template <int Q>
cudaError_t resident(size_t smem, int sms, int* out) {
  cudaError_t err = prepare<Q>(smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, split_cells_kernel<Q>);
  if (err != cudaSuccess) return err;
  out[2] = (int)smem;
  out[3] = fa.numRegs;
  out[4] = (int)fa.localSizeBytes;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], split_cells_kernel<Q>, THREADS, smem);
  if (err != cudaSuccess) return err;
  if constexpr (Q == 1) {
    out[1] = out[0] * sms;
    return cudaSuccess;
  } else {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config<Q>(sms, smem, 0, attr);
    return cudaOccupancyMaxActiveClusters(&out[1], split_cells_kernel<Q>,
                                          &cfg);
  }
}

template <int Q>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err = prepare<Q>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config<Q>(a.C, smem, stream, attr);
  err = cudaLaunchKernelEx(&cfg, split_cells_kernel<Q>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The launch shapes of a chunk's tiles and tables: for Q = 1, 2, 4 (rows
// of five in out) the resident blocks per SM, the clusters resident on the
// whole card, the dynamic shared bytes a block, the registers and the local
// bytes (spills) of a thread; then the threads of a block and the card's
// SMs (out[15], out[16]).  Returns a cudaError_t code.
extern "C" int split_cells_shape(int ny, int nx, int R2, int e_total,
                                 int* out) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = resident<1>(shared_bytes(1, ny, nx, R2, e_total), sms, &out[0]);
  if (err == cudaSuccess)
    err = resident<2>(shared_bytes(2, ny, nx, R2, e_total), sms, &out[5]);
  if (err == cudaSuccess)
    err = resident<4>(shared_bytes(4, ny, nx, R2, e_total), sms, &out[10]);
  out[15] = THREADS;
  out[16] = sms;
  return (int)err;
}

// Launch on `stream`: C cells' wavefront traces (layouts as in Args), each
// on a cluster of `cluster` blocks (1, 2 or 4).  Returns a cudaError_t code
// (0: launched).
extern "C" int split_cells_launch(
    const void* rec, const void* cell, const void* dirs, const void* geom,
    const void* fine, const void* sub_codes, const void* seeds, void* buf,
    void* tiles, void* trunc, void* pruned, void* peak, void* steps,
    void* work, int C, int P, int K, int R2, int num_fc, int num_oc, int ny,
    int nx, int max_steps, int per_cell_seeds, int circle, int grid_n,
    int sub, int e_ic, int e_r1, int e_r2, int e_hull, float thr,
    int cluster, void* stream) {
  if (C <= 0) return 0;
  if (P < 0 || 2 * P > K || K <= 0 ||
      R2 != 2 * (1 + num_fc + num_oc) || num_fc < 1 || num_oc < 1 ||
      ny < 1 || nx < 1 || (long long)ny * nx >= (1LL << 30) || grid_n < 1 ||
      sub < 1 ||
      e_ic < 0 || e_r1 < 0 || e_r2 < 0 || e_hull < 0 ||
      (cluster != 1 && cluster != 2 && cluster != 4))
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(cluster, ny, nx, R2,
                                   e_ic + e_r1 + e_r2 + e_hull);
  Args a;
  a.rec = static_cast<const float*>(rec);
  a.cell = static_cast<const float*>(cell);
  a.dirs = static_cast<const float*>(dirs);
  a.geom = static_cast<const float*>(geom);
  a.fine = static_cast<const int16_t*>(fine);
  a.sub_codes = static_cast<const uint8_t*>(sub_codes);
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
  a.sub = sub;
  a.e_ic = e_ic;
  a.e_r1 = e_r1;
  a.e_r2 = e_r2;
  a.e_hull = e_hull;
  a.thr = thr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cluster == 1) err = launch<1>(a, smem, s);
  else if (cluster == 2) err = launch<2>(a, smem, s);
  else err = launch<4>(a, smem, s);
  return (int)err;
}

extern "C" const char* split_cells_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
