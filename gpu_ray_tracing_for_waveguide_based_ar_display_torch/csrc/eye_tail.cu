// simulate's tail for NVIDIA Hopper (sm_90a): the pupil-window perception
// and the colorimetry of the eye-position stack.
//
// Replaces no TPU kernel.  The JAX package's tail is jnp, which XLA fuses:
// eval/metrics.py::eye_perceived_jnp (strided window einsums),
// ::eye_perceived_conv_jnp / ::pupil_conv (one convolution) and
// ::_make_eval_core (the colorimetry under evaluate_jnp and
// evaluate_jnp_batch).  Its plain PyTorch versions are the port's
// eval/metrics.py::eye_perceived_reference and ::_make_eval_core; on the card
// they would run through cuDNN, cuBLAS and dozens of eager kernels, whose
// first uses cost a fresh process hundreds of milliseconds.  This library is
// one module, loaded at bind (eye_tail_prepare).
//
// pupil_window_sum: (B, eby, ebx) float32 images -> (B, epy, epx) sums of the
// pupil disc's window at stride (sy, sx).  The disc goes in as per-row
// [start, end) column runs.  Each window's bins are added row-major into one
// float32 accumulator, each bin first multiplied by the image's scale when
// one is given (the product rounded to float32 before the add, as the plain
// version scales the image before it sums; -fmad=false keeps the two
// apart), so kernel and plain version agree bit for bit.  Bound: the
// images' bytes, read once, at the sampled grid's stride (the adds are ~0.1
// of it); the adds, one lane instruction each, at the dense stride.
//
// Design: a persistent grid, each block a ring of `stages` stages in
// shared memory (an image's rows that some window covers, or a band of
// them when an image does not fit twice) and one producer warp that stages
// the block's images in order, by cp.async.bulk copies completing on a
// stage's `full` mbarrier (one copy an image, or one a row for a strided
// view; loads and stores by the warp where the strides or the base break
// the copies' 16-byte rule).  The consumer threads take the items of the
// block's units in turn, each item waiting on its stage's `full` barrier
// and arriving on its `empty` barrier when summed; the producer refills a
// stage once all its items arrived, while the consumers sum the others.
// The ring's order (a wait on a barrier's parity is only sound while the
// barrier's previous phase has completed): `lead` (stages - 2, or
// stages - 1 in a ring of 2 or 3) units hold the items of the `active`
// consumers, at most lead * items of them, so a thread's first unit is
// below `lead` and its next item at most `lead` units on; and the producer
// issues unit n only once unit n - (stages - lead) landed, so when a
// thread's unit n' landed, every unit up to n' - (stages - lead) landed
// too, whatever order the copies complete in, and with it unit n - stages,
// its stage's previous phase.  A plan of one stage (a window row that
// does not fit twice) has no ring and no barriers: the whole block loads a
// unit, then sums it, between block barriers.  An item is `k` windows of
// one window row: at stride (sy, 1) DENSE_K horizontally adjacent windows,
// each bin of a row's run read once from shared memory and added to every
// window that covers it, in ascending column (each accumulator still takes
// its window's bins in the plain version's order); otherwise one window,
// read as float4 where the stride keeps every window 16-byte aligned.  The
// launch shape follows from the shape alone (window_sum_plan, mirrored by
// eval/eye_tail.py::window_sum_plan); an output never depends on it.
//
// colorimetry_units / colorimetry_image: (D, 3, fy*fx, P) perception stacks
// -> per design mean CIEDE2000 against D65, the sum over positions of min /
// max of Y, the per-position mean of Y (starved positions 0) and, with an
// image buffer, the eye views (D, fy*fx, 3, P) normalised by each
// position's peak.  The arithmetic is the plain version's, operation for
// operation in its order, with the constants the plain version rounds to
// float32 (the 3 x 3 products written out, no contraction: -fmad=false).
// What bounds it: the lane instructions of each (pixel, position) item's
// dependent chain (powf, atan2f, four cosf, expf, IEEE divisions and
// roots), not the bytes (the stack read once, the image written once).
//
// Design: a unit is 32 positions (the lanes: coalesced reads and image
// writes) by 8 groups of one split's pixels; the pixels of a position are
// split over S units (eval/eye_tail.py::colorimetry_splits, by the stack's
// shape alone), so that a stack of 56 positions and one of 4,641 each fill
// the card's resident blocks (5 blocks of 256 threads an SM: the kernel
// takes at most 48 registers).  Sums run in a fixed order that depends on
// the shape alone: per thread over its pixels, a fixed tree over the 8
// groups (the unit's partial), then, in the last unit of its 32 positions
// to finish (an integer atomic ticket), each of 8 groups over the splits
// s = g, g + 8, ... in order and a fixed tree over the groups, then over
// positions in the design's last such unit (a block-wide fixed tree,
// another ticket).  Min, max and "any Y = 0" are exact in any order; so
// is the peak of each position's eye view, which the same finisher takes
// over the splits.  With an image, the units write the views unnormalised
// and colorimetry_image, a second launch, divides each by its position's
// peak (the one pass that needs every split's peak): the image is read and
// written once more.  A run repeats itself bit for bit, and a design's
// results do not depend on the other designs of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include <mutex>

namespace {

// ---- perception ----------------------------------------------------------

// WS_MARK phases: setup wait sum release empty_wait stage
#ifndef WS_MARK
#define WS_BEGIN()
#define WS_MARK(k)
#define WS_END()
#endif

constexpr int MAX_DISC_ROWS = 128;
constexpr int MAX_STAGES = 8;        // stages a ring holds at most
constexpr int MAX_CONSUMERS = 512;   // summing threads a block at most
constexpr int PRODUCER = 32;         // the staging warp
constexpr int DENSE_K = 13;          // windows a thread at stride (sy, 1);
                                     // odd, so a warp's runs start in 32
                                     // distinct banks
constexpr int VEC_CHUNKS = 8;        // float4 chunks a row read at once
                                     // (a 30-bin row: 8 at most)
constexpr int BAR_BYTES = 16;        // a ring stage's full and empty
                                     // mbarriers
constexpr long long WAIT_POLLS = 1LL << 24;   // a longer wait traps

enum { FORM_SCALAR = 0, FORM_VEC4 = 1, FORM_DENSE = 2 };

struct Disc {
  int rows;                  // window rows
  int start[MAX_DISC_ROWS];  // per row: first column of the run
  int end[MAX_DISC_ROWS];    // per row: one past its last column
};

// The launch shape (window_sum_plan).  A unit is one stage's load: the
// window rows [band * band_rows, ...) of one image; an item is k windows of
// one of its window rows.
struct Plan {
  int form;          // FORM_*
  int k;             // windows an item: DENSE_K (FORM_DENSE) or 1
  int rows;          // the disc's rows
  int epy, epx;      // windows a column and a row of an image
  int band_rows;     // window rows a unit
  int bands;         // units an image
  int xblocks;       // items a window row
  int items;         // items a unit
  int stage_rows;    // image rows a full unit stages
  int stage_floats;  // floats a stage (a multiple of 4)
  int stages;        // the ring's stages (1: no ring)
  int lead;          // units whose items the consumers hold at once
  int consumers;     // consumer threads (a multiple of 32)
  int active;        // the consumers that sum: at most lead * items
  int smem;          // dynamic shared bytes: the stages, then the mbarriers
};

struct Sum {
  const float* images;   // image b, row y, column x at
                         // b * image_stride + y * row_stride + x
  const float* scale;    // (B,) or null
  float* out;            // (B, epy, epx)
  long long image_stride;
  long long units;       // B * bands
  int row_stride, ebx, sy, sx;
  int bulk;              // 1: cp.async.bulk copies; 0: loads and stores
  Plan p;
};

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

// The launch shape of a (rows x cols) disc over (eby x ebx) images at
// stride (sy, sx), given `limit` shared bytes a block: false when not one
// window row fits a stage.  A stage packs the rows that some window covers
// (ebx floats apart).  The form: DENSE_K windows a thread at stride
// (sy, 1) with at least DENSE_K windows a row, float4 reads where sx and
// ebx are multiples of 4, else scalar reads; a form whose
// window row does not fit falls back to the scalar one (no padding).  A
// stage holds every window row of an image if two such stages and their
// barriers fit, else the most window rows of which two (then one, with no
// barriers) fit.  The ring takes as many stages as fit (at most
// MAX_STAGES; one only where two do not).  The consumers: whole warps, at
// most the items of `lead` units (stages - 2, stages - 1 in a ring of 2 or
// 3, 1 without a ring), so that the producer refills the other stages
// while the consumers sum; of them the first lead * items sum where a
// warp is more.
static bool window_sum_plan(int eby, int ebx, int rows, int cols, int sy,
                            int sx, long long limit, Plan* p) {
  if (rows < 1 || cols < 1 || rows > eby || cols > ebx || sy < 1 || sx < 1)
    return false;
  p->rows = rows;
  p->epy = (eby - rows) / sy + 1;
  p->epx = (ebx - cols) / sx + 1;
  int form = sx == 1 && p->epx >= DENSE_K            ? FORM_DENSE
             : sx % 4 == 0 && ebx % 4 == 0            ? FORM_VEC4
                                                      : FORM_SCALAR;
  int pad = 0, band = 0;
  for (;;) {
    // floats a run reads past its row's end at most
    pad = form == FORM_DENSE ? DENSE_K - 1 : form == FORM_VEC4 ? 3 : 0;
    for (int want = 2; want >= 1 && band == 0; --want) {
      const long long fit =
          (want == 2 ? limit / 2 - BAR_BYTES : limit) / 4 / 4 * 4;
      const long long stage_rows = (fit - pad) / ebx;
      if (stage_rows >= rows)
        band = (int)(p->epy < (stage_rows - rows) / sy + 1
                         ? p->epy : (stage_rows - rows) / sy + 1);
    }
    if (band > 0) break;
    if (form == FORM_SCALAR) return false;
    form = FORM_SCALAR;
  }
  p->form = form;
  p->k = form == FORM_DENSE ? DENSE_K : 1;
  p->band_rows = band;
  p->bands = (int)ceil_div(p->epy, band);
  p->xblocks = (int)ceil_div(p->epx, p->k);
  p->items = band * p->xblocks;
  p->stage_rows = (band - 1) * sy + rows;
  p->stage_floats =
      (int)ceil_div((long long)p->stage_rows * ebx + pad, 4) * 4;
  const long long stage_bytes = (long long)p->stage_floats * 4 + BAR_BYTES;
  const long long fits = limit / stage_bytes;
  p->stages = (int)(fits < 2 ? 1 : fits < MAX_STAGES ? fits : MAX_STAGES);
  p->smem = (int)(p->stages > 1 ? p->stages * stage_bytes
                                : (long long)p->stage_floats * 4);
  p->lead = p->stages >= 4 ? p->stages - 2
            : p->stages >= 2 ? p->stages - 1
                             : 1;
  const long long held = (long long)p->lead * p->items;
  const long long most = held / 32 * 32;
  p->consumers = (int)(most < 32              ? 32
                       : most > MAX_CONSUMERS ? MAX_CONSUMERS
                                              : most);
  p->active = (int)(held < p->consumers ? held : p->consumers);
  return true;
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a wait on the barrier's phase `parity`; a wait past WAIT_POLLS polls (far
// beyond any unit's load or sum) traps rather than hang the card
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  for (long long polls = 0; !done; ++polls) {
    if (polls > WAIT_POLLS) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <bool SCALED>
__device__ __forceinline__ float bin(float v, float f) {
  return SCALED ? v * f : v;
}

// FORM_SCALAR: one window, a bin a load
template <bool SCALED>
__device__ __forceinline__ float sum_scalar(const float* base, int pitch,
                                            const Disc& disc, float f) {
  float acc = 0.0f;
  for (int dy = 0; dy < disc.rows; ++dy) {
    const float* r = base + dy * pitch;
    for (int c = disc.start[dy]; c < disc.end[dy]; ++c)
      acc += bin<SCALED>(r[c], f);
  }
  return acc;
}

// FORM_VEC4: one window whose rows start 16-byte aligned, read as float4
// chunks from the run's aligned start (c0); a chunk adds only the run's
// bins, in ascending column.
__device__ __forceinline__ void load_chunks(float4 (&v)[VEC_CHUNKS],
                                            const float* row, int c0,
                                            int e) {
  const float4* r = reinterpret_cast<const float4*>(row + c0);
#pragma unroll
  for (int i = 0; i < VEC_CHUNKS; ++i)
    if (c0 + 4 * i < e) v[i] = r[i];
}

template <bool SCALED>
__device__ __forceinline__ void add_chunks(float& acc,
                                           const float4 (&v)[VEC_CHUNKS],
                                           int c0, int s, int e, float f) {
#pragma unroll
  for (int i = 0; i < VEC_CHUNKS; ++i) {
    const int c = c0 + 4 * i;
    if (c >= s && c < e) acc += bin<SCALED>(v[i].x, f);
    if (c + 1 >= s && c + 1 < e) acc += bin<SCALED>(v[i].y, f);
    if (c + 2 >= s && c + 2 < e) acc += bin<SCALED>(v[i].z, f);
    if (c + 3 >= s && c + 3 < e) acc += bin<SCALED>(v[i].w, f);
  }
}

// A row's run, VEC_CHUNKS chunks at a time: every load of a piece before
// its adds, so the chain of adds waits on one load latency a piece.
template <bool SCALED>
__device__ __forceinline__ float sum_vec4(const float* base, int pitch,
                                          const Disc& disc, float f) {
  float acc = 0.0f;
  for (int dy = 0; dy < disc.rows; ++dy) {
    const int s = disc.start[dy], e = disc.end[dy];
    for (int c0 = s & ~3; c0 < e; c0 += 4 * VEC_CHUNKS) {
      float4 v[VEC_CHUNKS];
      load_chunks(v, base + dy * pitch, c0, e);
      add_chunks<SCALED>(acc, v, c0, s, e, f);
    }
  }
  return acc;
}

// FORM_DENSE: DENSE_K horizontally adjacent windows at stride (sy, 1),
// window j's row covering the columns [start + j, end + j).  A row's run
// [start, end + K - 1) is read once: bin c goes to windows
// max(0, c - end + 1) .. min(K - 1, c - start), in ascending c, so each
// accumulator takes its window's bins in the plain version's order.  A run
// shorter than K - 1 bins is added window by window.
template <bool SCALED>
__device__ __forceinline__ void sum_dense(const float* base, int pitch,
                                          const Disc& disc, float f,
                                          float (&acc)[DENSE_K]) {
  constexpr int K = DENSE_K;
  for (int dy = 0; dy < disc.rows; ++dy) {
    const int s = disc.start[dy], e = disc.end[dy];
    const float* r = base + dy * pitch;
    if (e - s >= K - 1) {
#pragma unroll
      for (int h = 0; h < K - 1; ++h) {      // bins s .. s + K - 2
        const float x = bin<SCALED>(r[s + h], f);
#pragma unroll
        for (int j = 0; j <= h; ++j) acc[j] += x;
      }
#pragma unroll 4
      for (int c = s + K - 1; c < e; ++c) {  // every window
        const float x = bin<SCALED>(r[c], f);
#pragma unroll
        for (int j = 0; j < K; ++j) acc[j] += x;
      }
#pragma unroll
      for (int t = 0; t < K - 1; ++t) {      // bins e .. e + K - 2
        const float x = bin<SCALED>(r[e + t], f);
#pragma unroll
        for (int j = t + 1; j < K; ++j) acc[j] += x;
      }
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j)
        for (int c = s; c < e; ++c) acc[j] += bin<SCALED>(r[c + j], f);
    }
  }
}

// Item `item` of a staged unit (window rows band * band_rows + ..., of
// image b): its k windows summed into the output (none past the image's
// last window row).
template <int FORM, bool SCALED>
__device__ __forceinline__ void sum_item(const Sum& a, const Disc& disc,
                                         const float* stage, long long b,
                                         int band, int item) {
  const Plan& p = a.p;
  const int wy = item / p.xblocks;
  const int xb = item - wy * p.xblocks;
  const int iy = band * p.band_rows + wy;
  if (iy >= p.epy) return;
  const float f = SCALED ? a.scale[b] : 1.0f;
  const float* base =
      stage + (size_t)wy * a.sy * a.ebx + (size_t)xb * p.k * a.sx;
  float* dst = a.out + ((size_t)b * p.epy + iy) * p.epx;
  if constexpr (FORM == FORM_DENSE) {
    float acc[DENSE_K];
#pragma unroll
    for (int j = 0; j < DENSE_K; ++j) acc[j] = 0.0f;
    sum_dense<SCALED>(base, a.ebx, disc, f, acc);
    const int x0 = xb * DENSE_K;
#pragma unroll
    for (int j = 0; j < DENSE_K; ++j)
      if (x0 + j < p.epx) dst[x0 + j] = acc[j];
  } else if constexpr (FORM == FORM_VEC4) {
    dst[xb] = sum_vec4<SCALED>(base, a.ebx, disc, f);
  } else {
    dst[xb] = sum_scalar<SCALED>(base, a.ebx, disc, f);
  }
}

// Unit u: its image, band, and the source of its image rows and their
// count.
struct Unit {
  long long b;
  int band, nrows;
  const float* src;
};

__device__ __forceinline__ Unit unit_at(const Sum& a, long long u) {
  const Plan& p = a.p;
  Unit t;
  t.b = u / p.bands;
  t.band = (int)(u - t.b * p.bands);
  const int wy = min(p.band_rows, p.epy - t.band * p.band_rows);
  t.nrows = (wy - 1) * a.sy + p.rows;
  t.src = a.images + t.b * a.image_stride +
          (long long)t.band * p.band_rows * a.sy * a.row_stride;
  return t;
}

// Unit t's rows into dst, packed ebx floats apart, by loads and stores of
// `count` threads from `first`.
__device__ __forceinline__ void stage_rows(const Sum& a, const Unit& t,
                                           float* dst, int first,
                                           int count) {
  const int n = t.nrows * a.ebx;
  for (int i = first; i < n; i += count) {
    const int y = i / a.ebx;
    dst[i] = t.src[(long long)y * a.row_stride + (i - y * a.ebx)];
  }
}

template <int FORM, bool SCALED>
__global__ void __launch_bounds__(MAX_CONSUMERS + PRODUCER)
pupil_window_sum(const Sum a, const Disc disc) {
  extern __shared__ __align__(16) float ring[];
  const Plan& p = a.p;
  const int tid = threadIdx.x;
  const long long grid = gridDim.x;
  const int mine = (int)((a.units - 1 - blockIdx.x) / grid + 1);
  WS_BEGIN();
  if (p.stages == 1) {
    // no ring: the block loads a unit, then its active threads sum it
    for (int n = 0; n < mine; ++n) {
      const Unit t = unit_at(a, blockIdx.x + (long long)n * grid);
      __syncthreads();                // the unit before it summed
      WS_MARK(5);
      stage_rows(a, t, ring, tid, blockDim.x);
      __syncthreads();
      WS_MARK(6);
      for (int item = tid; item < p.items && tid < p.active;
           item += p.active)
        sum_item<FORM, SCALED>(a, disc, ring, t.b, t.band, item);
      WS_MARK(3);
    }
    WS_END();
    return;
  }
  unsigned long long* full = reinterpret_cast<unsigned long long*>(
      ring + (size_t)p.stages * p.stage_floats);
  unsigned long long* empty = full + p.stages;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, a.bulk ? 1 : PRODUCER);
      mbar_init(empty + s, p.items);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  WS_MARK(1);
  if (tid >= p.consumers) {
    // the producer warp: the block's units in order, unit n into stage
    // n % stages once the consumers released the unit before it there and
    // unit n - ahead landed
    const int lane = tid & 31;
    const int ahead = p.stages - p.lead;
    for (int n = 0; n < mine; ++n) {
      const int s = n % p.stages;
      const int use = n / p.stages;
      if (use > 0) mbar_wait(empty + s, (unsigned)(use - 1) & 1u);
      if (n >= ahead)
        mbar_wait(full + (n - ahead) % p.stages,
                  (unsigned)((n - ahead) / p.stages) & 1u);
      WS_MARK(5);
      const Unit t = unit_at(a, blockIdx.x + (long long)n * grid);
      float* dst = ring + (size_t)s * p.stage_floats;
      if (a.bulk) {
        const unsigned bytes = (unsigned)t.nrows * (unsigned)a.ebx * 4u;
        if (lane == 0) mbar_expect(full + s, bytes);
        __syncwarp();
        if (a.row_stride == a.ebx) {               // one copy
          if (lane == 0) bulk_load(dst, t.src, bytes, full + s);
        } else {                                   // one copy a row
          for (int y = lane; y < t.nrows; y += 32)
            bulk_load(dst + (size_t)y * a.ebx,
                      t.src + (long long)y * a.row_stride,
                      (unsigned)a.ebx * 4u, full + s);
        }
      } else {
        stage_rows(a, t, dst, lane, 32);
        mbar_arrive(full + s);   // each lane: its stores released
      }
      WS_MARK(6);
    }
    WS_END();
    return;
  }
  if (tid >= p.active) {
    WS_END();
    return;
  }
  // the active consumers: item g of the block's units (unit g / items),
  // every active-th, stepped in 32 bits (a 64-bit division is a long
  // subroutine); each waits on its stage's full barrier (also an item past
  // the image's last window row: its arrival then counts to its own unit)
  // and arrives on its empty barrier when summed
  const int step_n = p.active / p.items, step_i = p.active % p.items;
  int n = tid / p.items, item = tid % p.items;
  for (; n < mine; n += step_n, item += step_i) {
    if (item >= p.items) {
      item -= p.items;
      if (++n >= mine) break;
    }
    const int s = n % p.stages;
    const long long u = blockIdx.x + (long long)n * grid;
    long long b = u;
    int band = 0;
    if (p.bands > 1) {
      b = u / p.bands;
      band = (int)(u - b * p.bands);
    }
    mbar_wait(full + s, (unsigned)(n / p.stages) & 1u);
    WS_MARK(2);
    sum_item<FORM, SCALED>(a, disc, ring + (size_t)s * p.stage_floats, b,
                           band, item);
    WS_MARK(3);
    mbar_arrive(empty + s);
    WS_MARK(4);
  }
  WS_END();
}

const void* window_kernel(int form, bool scaled) {
  switch (form * 2 + (scaled ? 1 : 0)) {
    case 0: return (const void*)pupil_window_sum<FORM_SCALAR, false>;
    case 1: return (const void*)pupil_window_sum<FORM_SCALAR, true>;
    case 2: return (const void*)pupil_window_sum<FORM_VEC4, false>;
    case 3: return (const void*)pupil_window_sum<FORM_VEC4, true>;
    case 4: return (const void*)pupil_window_sum<FORM_DENSE, false>;
    default: return (const void*)pupil_window_sum<FORM_DENSE, true>;
  }
}

// The card's shared bytes a block may take: the opt-in maximum less the
// largest static shared memory of the six instantiations (none in this
// build), read once.
cudaError_t window_sum_limit(long long* limit) {
  static long long cached = -1;
  if (cached < 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    size_t most = 0;
    for (int i = 0; i < 6 && err == cudaSuccess; ++i) {
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, window_kernel(i / 2, i % 2));
      if (err == cudaSuccess && attr.sharedSizeBytes > most)
        most = attr.sharedSizeBytes;
    }
    if (err != cudaSuccess) return err;
    cached = (long long)optin - (long long)most;
  }
  *limit = cached;
  return cudaSuccess;
}

// The plan on this card for one shape, its kernel (its dynamic shared
// memory raised to the card's limit), resident blocks per SM and the SMs.
struct Setup {
  int key[8];   // device, eby, ebx, rows, cols, sy, sx, scaled
  Plan p;
  const void* fn;
  int blocks_per_sm, sms;
};

constexpr int SETUPS = 32;   // shapes kept (the oldest replaced)
std::mutex setup_mutex;      // guards setups and last_launch
Setup setups[SETUPS];
int setups_made = 0;
long long last_launch[2];    // the last launch's grid and staging (bulk)

// The setup of a shape, worked out at its first call and kept: a launch
// then asks the runtime for the current device alone.  Caller holds
// setup_mutex.
cudaError_t window_sum_setup(int eby, int ebx, int rows, int cols, int sy,
                             int sx, bool scaled, const Setup** out,
                             long long* limit) {
  cudaError_t err = window_sum_limit(limit);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int key[8] = {dev, eby, ebx, rows, cols, sy, sx, scaled ? 1 : 0};
  const int kept = setups_made < SETUPS ? setups_made : SETUPS;
  for (int i = 0; i < kept; ++i)
    if (memcmp(setups[i].key, key, sizeof(key)) == 0) {
      *out = setups + i;
      return cudaSuccess;
    }
  Setup t;
  memcpy(t.key, key, sizeof(key));
  if (!window_sum_plan(eby, ebx, rows, cols, sy, sx, *limit, &t.p))
    return cudaErrorInvalidValue;
  t.fn = window_kernel(t.p.form, scaled);
  err = cudaDeviceGetAttribute(&t.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        t.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*limit);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &t.blocks_per_sm, t.fn, t.p.consumers + PRODUCER, t.p.smem);
  if (err == cudaSuccess && t.blocks_per_sm < 1) err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  Setup* slot = setups + setups_made++ % SETUPS;
  *slot = t;
  *out = slot;
  return cudaSuccess;
}

// ---- colorimetry ---------------------------------------------------------

constexpr int LANES = 32;    // positions per unit
constexpr int GROUPS = 8;    // pixel groups per unit
constexpr int COLOR_THREADS = LANES * GROUPS;
constexpr int COLOR_MIN_BLOCKS = 5;    // blocks an SM: 48 registers at most
constexpr int IMAGE_THREADS = 256;
constexpr int IMAGE_BLOCKS_PER_SM = 8; // colorimetry_image's grid an SM

// the float32 constants, in eval/eye_tail.py::colorimetry_constants' order
enum {
  K_DRIVE = 0,               // 3: pure-white drive of the display primaries
  K_MXYZ = 3,                // 9: DISPLAY_M_XYZ, row-major
  K_MRGB = 12,               // 9: DISPLAY_M, row-major
  K_LABW = 21,               // 3: Lab of the D65 stimulus
  K_WP = 24,                 // 3: the D65 whitepoint at Y = 1
  K_YFLOOR = 27, K_HUNDRED, K_DELTA3, K_LINDIV, K_LINADD, K_THIRD, K_L116,
  K_L16, K_A500, K_B200, K_POW25_7, K_RAD2DEG, K_DEG2RAD, K_C017, K_C024,
  K_C032, K_C020, K_C015, K_C045, K_SRGB_LIN, K_SRGB_MUL, K_SRGB_A,
  K_SRGB_EXP, K_SRGB_SUB,
  NCONST
};

struct Consts {
  float c[NCONST];
};

// per (design, split, position) partials
enum { P_DE, P_Y, P_YMIN, P_YMAX, P_ZERO, P_PEAK, NPART };
// per (design, position) results
enum { Q_DE, Q_RATIO, Q_PEAK, NPOS };

struct Color {
  const float* perc;   // (D, 3, npix, P), (B, G, R) wavelength order
  float* image;        // (D, npix, 3, P) or null
  float* part;         // (D, S, NPART, P)
  float* pos;          // (D, NPOS, P): delta E sum, min / max ratio, peak
  int* done;           // (D * tiles + D,), zeroed per launch: the units
                       // finished per (design, tile), then the tiles
                       // finished per design
  float* delta_e;      // (D,)
  float* ratio_sum;    // (D,)
  float* u_eb;         // (D, P)
  float inv_norm;
  int npix, P, S, chunk, tiles;
};

// torch.remainder(x, 360.0)
__device__ __forceinline__ float mod360(float x) {
  float m = fmodf(x, 360.0f);
  if (m != 0.0f && m < 0.0f) m += 360.0f;
  return m;
}

// eval/color.py::delta_e_2000 in its order (k_l = k_c = k_h = 1)
__device__ float delta_e_2000(float l1, float a1, float b1, float l2,
                              float a2, float b2, const Consts& k) {
  const float* c = k.c;
  const float c1 = hypotf(a1, b1);
  const float c2 = hypotf(a2, b2);
  const float c_bar = 0.5f * (c1 + c2);
  const float cb7 = powf(c_bar, 7.0f);
  const float g = 0.5f * (1.0f - sqrtf(cb7 / (cb7 + c[K_POW25_7])));
  const float a1p = (1.0f + g) * a1;
  const float a2p = (1.0f + g) * a2;
  const float c1p = hypotf(a1p, b1);
  const float c2p = hypotf(a2p, b2);
  const float h1p = mod360(atan2f(b1, a1p) * c[K_RAD2DEG]);
  const float h2p = mod360(atan2f(b2, a2p) * c[K_RAD2DEG]);
  const float dl = l2 - l1;
  const float dc = c2p - c1p;
  const float dh_cond = h2p - h1p;
  const float cc = c1p * c2p;
  const float dhp =
      cc == 0.0f ? 0.0f
      : fabsf(dh_cond) <= 180.0f ? dh_cond
      : dh_cond > 180.0f ? dh_cond - 360.0f
                         : dh_cond + 360.0f;
  const float dH = 2.0f * sqrtf(cc) * sinf(dhp * c[K_DEG2RAD] / 2.0f);
  const float l_bar = 0.5f * (l1 + l2);
  const float cp_bar = 0.5f * (c1p + c2p);
  const float h_sum = h1p + h2p;
  const float h_diff = fabsf(h1p - h2p);
  const float hp_bar =
      cc == 0.0f ? h_sum
      : h_diff <= 180.0f ? 0.5f * h_sum
      : h_sum < 360.0f ? 0.5f * (h_sum + 360.0f)
                       : 0.5f * (h_sum - 360.0f);
  const float t = 1.0f - c[K_C017] * cosf((hp_bar - 30.0f) * c[K_DEG2RAD])
                  + c[K_C024] * cosf((2.0f * hp_bar) * c[K_DEG2RAD])
                  + c[K_C032] * cosf((3.0f * hp_bar + 6.0f) * c[K_DEG2RAD])
                  - c[K_C020] * cosf((4.0f * hp_bar - 63.0f) * c[K_DEG2RAD]);
  const float q = (hp_bar - 275.0f) / 25.0f;
  const float d_theta = 30.0f * expf(-(q * q));
  const float cp7 = powf(cp_bar, 7.0f);
  const float r_c = 2.0f * sqrtf(cp7 / (cp7 + c[K_POW25_7]));
  const float lb = l_bar - 50.0f;
  const float s_l = 1.0f + c[K_C015] * (lb * lb) / sqrtf(20.0f + lb * lb);
  const float s_c = 1.0f + c[K_C045] * cp_bar;
  const float s_h = 1.0f + c[K_C015] * cp_bar * t;
  const float r_t = -sinf((2.0f * d_theta) * c[K_DEG2RAD]) * r_c;
  const float term_l = dl / (1.0f * s_l);
  const float term_c = dc / (1.0f * s_c);
  const float term_h = dH / (1.0f * s_h);
  return sqrtf(term_l * term_l + term_c * term_c + term_h * term_h
               + r_t * term_c * term_h);
}

// eval/color.py::xyz_to_lab's f(t) on one normalised channel
__device__ __forceinline__ float lab_f(float t, const float* c) {
  return t > c[K_DELTA3] ? powf(fabsf(t), c[K_THIRD])
                         : t / c[K_LINDIV] + c[K_LINADD];
}

__device__ __forceinline__ float sum8(const float* v) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// COLOR_MARK phases: items reduce finish design image
#ifndef COLOR_MARK
#define COLOR_BEGIN()
#define COLOR_MARK(k)
#define COLOR_END()
#endif

// a unit's partials of the 32 positions of position tile `tile`: per
// thread over the pixels s * chunk + ty, + 8, ..., then a fixed tree over
// the 8 groups; the eye views written unnormalised
__device__ __forceinline__ void color_unit(const Color& a, const Consts& k,
                                           int d, int s, int tile,
                                           float (&red)[NPART][GROUPS][LANES]) {
  const float* c = k.c;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p = tile * LANES + tx;
  float de = 0.0f, ys = 0.0f, ymin = INFINITY, ymax = -INFINITY;
  float zero = 0.0f, peak = -INFINITY;
  if (p < a.P) {
    const size_t plane = (size_t)a.npix * a.P;
    const float* src = a.perc + (size_t)d * 3 * plane + p;
    const int i0 = s * a.chunk + ty, i1 = min(a.npix, (s + 1) * a.chunk);
    // each item's three channels are loaded one item ahead
    float next[3] = {0.0f, 0.0f, 0.0f};
    if (i0 < i1)
      for (int j = 0; j < 3; ++j) next[j] = src[(size_t)i0 * a.P + j * plane];
    for (int i = i0; i < i1; i += GROUPS) {
      const float in[3] = {next[0], next[1], next[2]};
      if (i + GROUPS < i1)
        for (int j = 0; j < 3; ++j)
          next[j] = src[(size_t)(i + GROUPS) * a.P + j * plane];
      // the (B, G, R) histogram order flipped to (R, G, B), each scaled by
      // 1 / norm, then by the drive
      float ep[3];
      for (int j = 0; j < 3; ++j)
        ep[j] = c[K_DRIVE + j] * (in[2 - j] * a.inv_norm);
      float xyz[3];
      for (int j = 0; j < 3; ++j) {
        const float* m = c + K_MXYZ + 3 * j;
        xyz[j] = ep[0] * m[0] + ep[1] * m[1] + ep[2] * m[2];
      }
      const float y = xyz[1];
      ys += y;
      ymin = fminf(ymin, y);
      ymax = fmaxf(ymax, y);
      float l = 0.0f, la = 0.0f, lb = 0.0f;
      if (y == 0.0f) {
        zero = 1.0f;
      } else {
        const float y_safe = fmaxf(y, c[K_YFLOOR]);
        float f[3];
        for (int j = 0; j < 3; ++j)
          f[j] = lab_f(xyz[j] / y_safe * c[K_HUNDRED] / c[K_WP + j], c);
        l = c[K_L116] * f[1] - c[K_L16];
        la = c[K_A500] * (f[0] - f[1]);
        lb = c[K_B200] * (f[1] - f[2]);
      }
      de += delta_e_2000(l, la, lb, c[K_LABW], c[K_LABW + 1],
                         c[K_LABW + 2], k);
      if (a.image) {
        float* dst = a.image + ((size_t)d * a.npix + i) * 3 * a.P + p;
        for (int j = 0; j < 3; ++j) {
          const float* m = c + K_MRGB + 3 * j;
          const float lin = fminf(
              fmaxf(ep[0] * m[0] + ep[1] * m[1] + ep[2] * m[2], 0.0f), 1.0f);
          const float v = lin <= c[K_SRGB_LIN]
                              ? lin * c[K_SRGB_MUL]
                              : c[K_SRGB_A] * powf(lin, c[K_SRGB_EXP])
                                    - c[K_SRGB_SUB];
          dst[(size_t)j * a.P] = v;
          peak = fmaxf(peak, v);
        }
      }
    }
  }
  red[P_DE][ty][tx] = de;
  red[P_Y][ty][tx] = ys;
  red[P_YMIN][ty][tx] = ymin;
  red[P_YMAX][ty][tx] = ymax;
  red[P_ZERO][ty][tx] = zero;
  red[P_PEAK][ty][tx] = peak;
}

// the 8 groups' values of quantity q at lane tx, combined: a fixed tree
// for the sums, min / max for the rest
__device__ __forceinline__ float combine8(
    const float (&red)[NPART][GROUPS][LANES], int q, int tx) {
  float v[GROUPS];
  for (int g = 0; g < GROUPS; ++g) v[g] = red[q][g][tx];
  if (q == P_DE || q == P_Y) return sum8(v);
  float r = v[0];
  for (int g = 1; g < GROUPS; ++g)
    r = q == P_YMIN ? fminf(r, v[g]) : fmaxf(r, v[g]);
  return r;
}

// quantity q's value of two partials a, b
__device__ __forceinline__ float merge(int q, float x, float y) {
  return q == P_DE || q == P_Y ? x + y
         : q == P_YMIN         ? fminf(x, y)
                               : fmaxf(x, y);
}

__global__ void __launch_bounds__(COLOR_THREADS, COLOR_MIN_BLOCKS)
colorimetry_units(const Color a, const Consts k) {
  __shared__ float red[NPART][GROUPS][LANES];
  __shared__ int last;
  COLOR_BEGIN();
  const int s = blockIdx.x, tile = blockIdx.y, d = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y, t = ty * LANES + tx;
  const int p = tile * LANES + tx;
  color_unit(a, k, d, s, tile, red);
  COLOR_MARK(1);
  __syncthreads();
  float* part = a.part + (size_t)d * a.S * NPART * a.P + p;
  const size_t stride = (size_t)NPART * a.P;
  if (ty == 0 && p < a.P) {
    for (int q = 0; q < NPART; ++q)
      part[s * stride + (size_t)q * a.P] = combine8(red, q, tx);
    __threadfence();
  }
  __syncthreads();
  if (t == 0)
    last = atomicAdd(a.done + d * a.tiles + tile, 1) == a.S - 1;
  __syncthreads();
  COLOR_MARK(2);
  if (!last) {
    COLOR_END();
    return;
  }
  // the tile's last unit: each group over the splits s = ty, ty + 8, ...
  // in order, then the groups' fixed tree
  __threadfence();
  if (p < a.P) {
    float acc[NPART];
    for (int q = 0; q < NPART; ++q)
      acc[q] = q == P_DE || q == P_Y || q == P_ZERO ? 0.0f
               : q == P_YMIN                        ? INFINITY
                                                    : -INFINITY;
    for (int j = ty; j < a.S; j += GROUPS)
      for (int q = 0; q < NPART; ++q)
        acc[q] =
            merge(q, acc[q], __ldcg(part + j * stride + (size_t)q * a.P));
    for (int q = 0; q < NPART; ++q) red[q][ty][tx] = acc[q];
  }
  __syncthreads();
  if (ty == 0 && p < a.P) {
    const float de = combine8(red, P_DE, tx);
    const float ys = combine8(red, P_Y, tx);
    const float ymin = combine8(red, P_YMIN, tx);
    const float ymax = combine8(red, P_YMAX, tx);
    const bool starved = combine8(red, P_ZERO, tx) != 0.0f;
    float* pos = a.pos + (size_t)d * NPOS * a.P + p;
    a.u_eb[(size_t)d * a.P + p] = starved ? 0.0f : ys / (float)a.npix;
    pos[(size_t)Q_DE * a.P] = de;
    pos[(size_t)Q_RATIO * a.P] =
        starved ? 0.0f : ymin / (ymax > 0.0f ? ymax : 1.0f);
    pos[(size_t)Q_PEAK * a.P] = combine8(red, P_PEAK, tx);
    __threadfence();
  }
  __syncthreads();
  if (t == 0)
    last = atomicAdd(a.done + (size_t)gridDim.z * a.tiles + d, 1) ==
           a.tiles - 1;
  __syncthreads();
  COLOR_MARK(3);
  if (!last) {
    COLOR_END();
    return;
  }
  // the design's last tile: sum over positions, fixed order
  __threadfence();
  __shared__ float sums[2][COLOR_THREADS];
  const float* pos = a.pos + (size_t)d * NPOS * a.P;
  float de = 0.0f, ratio = 0.0f;
  for (int i = t; i < a.P; i += COLOR_THREADS) {
    de += __ldcg(pos + (size_t)Q_DE * a.P + i);
    ratio += __ldcg(pos + (size_t)Q_RATIO * a.P + i);
  }
  sums[0][t] = de;
  sums[1][t] = ratio;
  __syncthreads();
  for (int w = COLOR_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      sums[0][t] += sums[0][t + w];
      sums[1][t] += sums[1][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    a.delta_e[d] = sums[0][0] / (float)((long long)a.P * a.npix);
    a.ratio_sum[d] = sums[1][0];
  }
  COLOR_MARK(4);
  COLOR_END();
}

// design blockIdx.y's eye views divided by their position's peak, where it
// is positive
__global__ void __launch_bounds__(IMAGE_THREADS)
colorimetry_image(const Color a) {
  COLOR_BEGIN();
  const int d = blockIdx.y, n = 3 * a.npix * a.P;
  float* img = a.image + (size_t)d * n;
  const float* peak = a.pos + ((size_t)d * NPOS + Q_PEAK) * a.P;
  for (int e = blockIdx.x * IMAGE_THREADS + threadIdx.x; e < n;
       e += gridDim.x * IMAGE_THREADS) {
    const float m = peak[e % a.P];
    if (m > 0.0f) img[e] = img[e] / m;
  }
  COLOR_MARK(5);
  COLOR_END();
}

}  // namespace

// Load the module now, not at the first launch: the function attributes
// are read from each kernel (a lazily loaded module loads here).  Returns a
// cudaError_t code (0: loaded).
extern "C" int eye_tail_prepare(void) {
  cudaFuncAttributes attr;
  const void* fns[] = {(const void*)colorimetry_units,
                       (const void*)colorimetry_image};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  long long limit = 0;
  return (int)window_sum_limit(&limit);
}

// The window sum's launch shape on this card for a (rows x cols) disc over
// (eby x ebx) images at stride (sy, sx), scaled or not: out[17] = form,
// windows a thread, stages, lead, consumers, active consumers, threads a
// block, window rows a unit, units an image, items a unit, floats a stage,
// dynamic shared bytes, resident blocks per SM, registers, local bytes a
// thread, SMs, shared bytes a block may take.  Returns a cudaError_t code
// (cudaErrorInvalidValue: no window row fits a stage).
extern "C" int window_sum_shape(int eby, int ebx, int rows, int cols, int sy,
                                int sx, int scaled, int* out) {
  std::lock_guard<std::mutex> hold(setup_mutex);
  const Setup* t = nullptr;
  long long limit = 0;
  cudaError_t err = window_sum_setup(eby, ebx, rows, cols, sy, sx,
                                     scaled != 0, &t, &limit);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, t->fn);
  if (err != cudaSuccess) return (int)err;
  const Plan& p = t->p;
  const int v[17] = {p.form, p.k, p.stages, p.lead, p.consumers, p.active,
                     p.consumers + PRODUCER, p.band_rows, p.bands, p.items,
                     p.stage_floats, p.smem, t->blocks_per_sm, attr.numRegs,
                     (int)attr.localSizeBytes, t->sms, (int)limit};
  memcpy(out, v, sizeof(v));
  return 0;
}

// Launch on `stream`: out (B, epy, epx) = the disc's window sums of B images
// (image b at images + b * image_stride, rows row_stride apart), each first
// multiplied by scale[b] when scale is not null.  The disc: `rows` rows,
// row r covering columns [segments[2r], segments[2r + 1]) (host array).
// The grid: the card's resident blocks of the plan's kernel, at most one a
// unit.  Returns a cudaError_t code (0: launched).
extern "C" int pupil_window_sum_launch(
    const void* images, const void* scale, void* out, long long image_stride,
    int row_stride, int B, int eby, int ebx, int sy, int sx,
    const int* segments, int rows, int cols, void* stream) {
  if (B <= 0) return 0;
  if (rows <= 0 || rows > MAX_DISC_ROWS || cols <= 0 || rows > eby ||
      cols > ebx || sy <= 0 || sx <= 0 || row_stride < ebx)
    return (int)cudaErrorInvalidValue;
  Disc disc;
  disc.rows = rows;
  for (int r = 0; r < rows; ++r) {
    disc.start[r] = segments[2 * r];
    disc.end[r] = segments[2 * r + 1];
    if (disc.start[r] < 0 || disc.end[r] < disc.start[r] ||
        disc.end[r] > cols)
      return (int)cudaErrorInvalidValue;
  }
  std::lock_guard<std::mutex> hold(setup_mutex);
  const Setup* t = nullptr;
  long long limit = 0;
  cudaError_t err = window_sum_setup(eby, ebx, rows, cols, sy, sx,
                                     scale != nullptr, &t, &limit);
  if (err != cudaSuccess) return (int)err;
  Sum a;
  a.p = t->p;
  a.images = static_cast<const float*>(images);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.image_stride = image_stride;
  a.units = (long long)B * a.p.bands;
  a.row_stride = row_stride;
  a.ebx = ebx;
  a.sy = sy;
  a.sx = sx;
  // a ring's copies, under their 16-byte rule: base, image and row
  // strides, row length
  a.bulk = a.p.stages > 1 &&
           reinterpret_cast<unsigned long long>(images) % 16 == 0 &&
           image_stride % 4 == 0 && row_stride % 4 == 0 && ebx % 4 == 0;
  const long long resident = (long long)t->blocks_per_sm * t->sms;
  const unsigned grid =
      (unsigned)(a.units < resident ? a.units : resident);
  last_launch[0] = grid;
  last_launch[1] = a.bulk;
  void* args[] = {(void*)&a, (void*)&disc};
  err = cudaLaunchKernel(t->fn, dim3(grid), dim3(a.p.consumers + PRODUCER),
                         args, (size_t)a.p.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The last pupil_window_sum_launch's grid and staging (1: bulk copies, 0:
// loads and stores): out[2].
extern "C" void window_sum_last_launch(long long* out) {
  std::lock_guard<std::mutex> hold(setup_mutex);
  out[0] = last_launch[0];
  out[1] = last_launch[1];
}

// The colorimetry's kernels on this card: out[7] = colorimetry_units'
// registers, local bytes a thread and resident blocks per SM, the same of
// colorimetry_image, and the SMs.  Returns a cudaError_t code (0: read).
extern "C" int colorimetry_shape(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const void* fns[2] = {(const void*)colorimetry_units,
                        (const void*)colorimetry_image};
  const int threads[2] = {COLOR_THREADS, IMAGE_THREADS};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    cudaFuncAttributes attr;
    int blocks = 0;
    err = cudaFuncGetAttributes(&attr, fns[i]);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i],
                                                          threads[i], 0);
    out[3 * i] = attr.numRegs;
    out[3 * i + 1] = (int)attr.localSizeBytes;
    out[3 * i + 2] = blocks;
  }
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out + 6, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// Launch on `stream`: the colorimetry of D (3, npix, P) stacks.  `image`
// may be null (no eye views; no second launch).  Scratch: part (D * S * 6
// * P floats), pos (D * 3 * P floats), done (D * ceil(P / 32) + D ints,
// zeroed here).  consts: the NCONST float32 constants (host array).  S
// splits of `chunk` pixels (every split holding some).  Returns a
// cudaError_t code (0: launched).
extern "C" int colorimetry_launch(
    const void* perc, void* image, void* part, void* pos, void* done,
    void* delta_e, void* ratio_sum, void* u_eb, const float* consts,
    int nconst, float inv_norm, int D, int npix, int P, int S, int chunk,
    void* stream) {
  if (D <= 0) return 0;
  const int tiles = (int)(((long long)P + LANES - 1) / LANES);
  if (nconst != NCONST || npix <= 0 || P <= 0 || S <= 0 || chunk <= 0 ||
      (long long)S * chunk < npix || (long long)(S - 1) * chunk >= npix ||
      tiles > 65535 || D > 65535 || 3LL * npix * P > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Consts k;
  memcpy(k.c, consts, sizeof(k.c));
  Color a;
  a.perc = static_cast<const float*>(perc);
  a.image = static_cast<float*>(image);
  a.part = static_cast<float*>(part);
  a.pos = static_cast<float*>(pos);
  a.done = static_cast<int*>(done);
  a.delta_e = static_cast<float*>(delta_e);
  a.ratio_sum = static_cast<float*>(ratio_sum);
  a.u_eb = static_cast<float*>(u_eb);
  a.inv_norm = inv_norm;
  a.npix = npix;
  a.P = P;
  a.S = S;
  a.chunk = chunk;
  a.tiles = tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(done, 0, sizeof(int) * ((size_t)D * tiles + D), st);
  if (err != cudaSuccess) return (int)err;
  colorimetry_units<<<dim3(S, tiles, D), dim3(LANES, GROUPS), 0, st>>>(a, k);
  err = cudaGetLastError();
  if (err != cudaSuccess || !image) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n = 3LL * npix * P;
  const long long want = (n + IMAGE_THREADS - 1) / IMAGE_THREADS;
  const long long most = ((long long)IMAGE_BLOCKS_PER_SM * sms + D - 1) / D;
  colorimetry_image<<<dim3((unsigned)(want < most ? want : most), D),
                      IMAGE_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* eye_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
