// Kernel cell rows of synthetic LUTs for NVIDIA Hopper (sm_90a).
//
// Replaces host numpy, not a TPU kernel: the synthetic-LUT -> cell-table ->
// row pipeline of luts/packing.py::build_cell_tables_synthetic_batch (and
// build_cell_tables over luts/synthetic.py::make_synthetic_luts) followed by
// engine/trace_rows.py::build_kernel_cell_params.  The JAX package builds
// the same rows on the host (luts/packing.py, engine/trace_pallas.py).  The
// transcendentals stay on the host (engine/cell_rows.py::
// synthetic_row_inputs: each branch's efficiency profile p, cos / sin of its
// rotation, the phasors of its diagonal, the angle cosines, the TIR phasors
// and hop angles); this kernel does every IEEE-exact step after them, in
// numpy's order: per cell and branch the scale
// c = sqrt(p * cos_in / (cos_out * extra)), the unitary's entries and c * U
// as numpy forms a float64 times a complex128 product (the real operand as
// (a, 0): re = a*br - 0*bi, im = a*bi + 0*br), their rounding to float32, the
// float32 scale, eyebox and deposit columns, and every write into the
// (D*C, 704) float32 row layout of engine/trace_rows.py.  The plain PyTorch
// version is engine/cell_rows.py::cell_rows_reference; every operation here
// is a correctly rounded intrinsic (__dmul_rn, __ddiv_rn, __dsqrt_rn,
// __double2float_rn, __fmul_rn, ...), so the two agree bit for bit, and with
// the host rows.
//
// What bounds it: the bytes written (the rows, 2,816 B a cell) and read
// (the branch inputs, 56 B per branch and cell, design-independent; the
// per-design cosines, gaps, phasors and rects); the float64 division and
// square root of each (branch, cell) item are far below the card's float64
// rate.
//
// Design.  A row is 176 float4 chunks; each is written exactly once, as one
// float4 store into a staged row: the 2B Jones chunks of the B branches
// (two a branch, at the branch's row offset), the scalar chunks (scale,
// gaps, phasors, rects, the strips' s_a / s_b) and the chunks the layout
// leaves empty, as zeros (chunk_kind, mirrored by engine/cell_rows.py::
// chunk_kinds).  Rows go in cell-major order r = c * D + d, so the rows of
// one cell's designs are neighbours and its branch inputs are read from
// device memory once, however many designs share them.  A persistent grid:
// block k owns rows [k * D*C / grid, (k + 1) * D*C / grid) and walks them
// in tiles of TILE rows through two staging buffers.  A tile's items are
// (branch, row) for the Jones chunks, then (scalar or zero chunk, row) for
// the rest, in one pass over the block's threads (a thread's items are its
// serial chain of loads: one pass takes fewer rounds than two), rows
// fastest: a quarter-warp stores one chunk of 8 consecutive staged rows,
// and the staged rows' pitch of 708 floats (177 float4) puts those 8
// stores in 8 distinct bank groups.  When the tile is staged, its rows go
// out by one cp.async.bulk copy each (2,816 contiguous bytes; the rows of
// one cell's designs lie C rows apart), thread i sending row i, while the
// block stages the next tile into the other buffer; a buffer is reused only
// after its copies have read it (cp.async.bulk.wait_group.read), so a tile
// costs one block barrier.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

// ROWS_MARK phases: items wait store
#ifndef ROWS_MARK
#define ROWS_BEGIN()
#define ROWS_MARK(k)
#define ROWS_END()
#endif

namespace {

// the row layout of engine/trace_rows.py
constexpr int PC = 704;
constexpr int FC_BLK = 96, FC_STRIDE = 36, OC_BLK = 352, OC_STRIDE = 56;
constexpr int EBT = 688, EBS = 692;
constexpr int MAX_FC = (OC_BLK - FC_BLK) / FC_STRIDE;  // 7
constexpr int MAX_OC = (EBT - OC_BLK) / OC_STRIDE;     // 6
constexpr int MAX_B = 6 + 4 * MAX_FC + 6 * MAX_OC;      // 70 branches

constexpr int CHUNKS = PC / 4;     // float4 chunks a row
constexpr int PITCH = PC + 4;      // floats a staged row: 177 float4
constexpr unsigned ROW_BYTES = PC * 4;
constexpr int TILE = 32;           // rows a staging buffer
constexpr int BUFS = 2;
constexpr int THREADS = 1024;
constexpr int MIN_BLOCKS = 1;      // a block an SM: two buffers
constexpr int NCOS = 5;            // angle cosines: air, ic, ic2, fc, oc
constexpr int NPH = 18;            // TIR and hop-2 phasors (re, im) x 4, 2
                                   // angles
constexpr int COS_AIR = 0, COS_IC = 1, COS_IC2 = 2, COS_FC = 3, COS_OC = 4;
constexpr int SMEM = BUFS * TILE * PITCH * 4 + MAX_B * 4 * 4 + 2 * CHUNKS;

// what a chunk of the row holds (engine/cell_rows.py::CHUNK_KINDS)
enum Kind {
  K_ZERO = 0,      // padding, or a strip the design does not have
  K_JONES,         // half of a branch's 8 Jones floats
  K_INIT,          // ic * n_g, ic2 * n_g, cos_air, cos_air / n_g (16-19)
  K_GAPS0,         // the TIR hops (20-27)
  K_GAPS1,
  K_PH0,           // the TIR and hop-2 phasors (28-43)
  K_PH1,
  K_PH2,
  K_PH3,
  K_EBR,           // the deposit rect (44-47)
  K_IC_S,          // ic, ic2, 0, 0 (80-83)
  K_FC_S,          // an FC strip's ic, fc, 0, 0
  K_OC_S,          // an OC strip's fc, oc, 0, 0
  K_EBT,           // the widened rect (688-691)
  K_EBS_HOP        // the deposit bin scales, the hop-2 angles (692-695)
};

// the kind of chunk q (4q .. 4q + 3) of a row with nf FC and no OC strips
__host__ __device__ inline int chunk_kind(int q, int nf, int no) {
  if (q < 4) return K_JONES;                       // init Jones A, B
  if (q == 4) return K_INIT;
  if (q < 7) return K_GAPS0 + (q - 5);
  if (q < 11) return K_PH0 + (q - 7);
  if (q == 11) return K_EBR;
  if (q < 20) return K_JONES;                      // the IC block
  if (q == 20) return K_IC_S;
  if (q < FC_BLK / 4) return K_ZERO;
  if (q < FC_BLK / 4 + 9 * MAX_FC) {
    const int s = (q - FC_BLK / 4) / 9, e = (q - FC_BLK / 4) % 9;
    return s >= nf ? K_ZERO : e < 8 ? K_JONES : K_FC_S;
  }
  if (q < OC_BLK / 4) return K_ZERO;
  if (q < EBT / 4) {
    const int s = (q - OC_BLK / 4) / 14, e = (q - OC_BLK / 4) % 14;
    return s >= no ? K_ZERO : e < 12 ? K_JONES : e == 12 ? K_OC_S : K_ZERO;
  }
  if (q == EBT / 4) return K_EBT;
  if (q == EBS / 4) return K_EBS_HOP;
  return K_ZERO;
}

struct Args {
  const double* branch;   // (B, 7, C): p, cos b, sin b, Re/Im e1, Re/Im e2
  const int* table;       // (B, 4): cos_in, cos_out, extra (0: 1, 1: n_g,
                          // 2: 1 / n_g), row offset
  const double* cosines;  // (D, 5, C)
  const double* glass;    // (D, 2): n_g, 1 / n_g
  const double* gaps;     // (D, C, 8)
  const float* phasors;   // (D, C, 18)
  const double* eyebox;   // (D, MN, 4)
  float* rows;            // (D * C, PC)
  int total;              // D * C
  int D, C, MN, B, num_fc, num_oc;
  float ny, nx, tol;
};

// a float64 times a complex128 as numpy computes it: (a, 0) * (br, bi)
__device__ __forceinline__ void real_times_complex(double a, double br,
                                                   double bi, double& re,
                                                   double& im) {
  re = __dsub_rn(__dmul_rn(a, br), __dmul_rn(0.0, bi));
  im = __dadd_rn(__dmul_rn(a, bi), __dmul_rn(0.0, br));
}

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

// this thread's shared-memory stores, made visible to the bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// `bytes` (a multiple of 16) from shared src to global dst, both 16-byte
// aligned, in this thread's current bulk group
__device__ __forceinline__ void bulk_store(float* dst, const float* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// this thread's bulk groups have all read their shared sources
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// this thread's bulk groups have all completed
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// the (design, cell) and global row of the tile row r (cell-major order)
__device__ __forceinline__ void row_of(const Args& a, int r, int& d, int& c,
                                       int& g) {
  c = r / a.D;
  d = r - c * a.D;
  g = d * a.C + c;
}

// branch b's 8 Jones floats of row (d, c): s * U as numpy forms them
__device__ __forceinline__ void jones(const Args& a, const int* t, int b,
                                      int d, int c, float4& lo, float4& hi) {
  const double* br = a.branch + (size_t)b * 7 * a.C + c;
  const double p = __ldg(br), cb = __ldg(br + (size_t)a.C);
  const double sb = __ldg(br + (size_t)2 * a.C);
  const double e1r = __ldg(br + (size_t)3 * a.C);
  const double e1i = __ldg(br + (size_t)4 * a.C);
  const double e2r = __ldg(br + (size_t)5 * a.C);
  const double e2i = __ldg(br + (size_t)6 * a.C);
  const double* cd = a.cosines + (size_t)d * NCOS * a.C + c;
  const double cin = __ldg(cd + (size_t)t[0] * a.C);
  const double cout = __ldg(cd + (size_t)t[1] * a.C);
  const double extra = t[2] == 0 ? 1.0 : __ldg(a.glass + 2 * d + t[2] - 1);
  const double s =
      __dsqrt_rn(__ddiv_rn(__dmul_rn(p, cin), __dmul_rn(cout, extra)));
  // U = [[cb e1, -sb e2], [sb e1, cb e2]], then s * U, row-major (re, im)
  double u[8];
  real_times_complex(cb, e1r, e1i, u[0], u[1]);
  real_times_complex(-sb, e2r, e2i, u[2], u[3]);
  real_times_complex(sb, e1r, e1i, u[4], u[5]);
  real_times_complex(cb, e2r, e2i, u[6], u[7]);
  float j[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    double jr, ji;
    real_times_complex(s, u[2 * k], u[2 * k + 1], jr, ji);
    j[2 * k] = __double2float_rn(jr);
    j[2 * k + 1] = __double2float_rn(ji);
  }
  lo = make_float4(j[0], j[1], j[2], j[3]);
  hi = make_float4(j[4], j[5], j[6], j[7]);
}

__device__ __forceinline__ float cos32(const Args& a, int d, int c, int k) {
  return __double2float_rn(a.cosines[((size_t)d * NCOS + k) * a.C + c]);
}

// the deposit rect of row (d, c) as float32
__device__ __forceinline__ float4 rect(const Args& a, int d, int c) {
  const double* eb = a.eyebox + ((size_t)d * a.MN + c % a.MN) * 4;
  return make_float4(__double2float_rn(eb[0]), __double2float_rn(eb[1]),
                     __double2float_rn(eb[2]), __double2float_rn(eb[3]));
}

// a scalar or zero chunk of row (d, c) (global row g), as the plain
// version writes its columns
__device__ __forceinline__ float4 other_chunk(const Args& a, int kind,
                                              int d, int c, int g) {
  switch (kind) {
    case K_INIT: {
      const float air = cos32(a, d, c, COS_AIR);
      const float ng = __double2float_rn(a.glass[2 * d]);
      return make_float4(__fmul_rn(cos32(a, d, c, COS_IC), ng),
                         __fmul_rn(cos32(a, d, c, COS_IC2), ng), air,
                         __fdiv_rn(air, ng));
    }
    case K_GAPS0:
    case K_GAPS1: {
      const double* gp = a.gaps + (size_t)g * 8 + 4 * (kind - K_GAPS0);
      return make_float4(__double2float_rn(gp[0]), __double2float_rn(gp[1]),
                         __double2float_rn(gp[2]), __double2float_rn(gp[3]));
    }
    case K_PH0:
    case K_PH1:
    case K_PH2:
    case K_PH3: {
      const float* ph = a.phasors + (size_t)g * NPH + 4 * (kind - K_PH0);
      return make_float4(ph[0], ph[1], ph[2], ph[3]);
    }
    case K_EBR:
      return rect(a, d, c);
    case K_IC_S:
      return make_float4(cos32(a, d, c, COS_IC), cos32(a, d, c, COS_IC2),
                         0.0f, 0.0f);
    case K_FC_S:
      return make_float4(cos32(a, d, c, COS_IC), cos32(a, d, c, COS_FC),
                         0.0f, 0.0f);
    case K_OC_S:
      return make_float4(cos32(a, d, c, COS_FC), cos32(a, d, c, COS_OC),
                         0.0f, 0.0f);
    case K_EBT: {
      const float4 r = rect(a, d, c);
      return make_float4(__fsub_rn(r.x, a.tol), __fadd_rn(r.y, a.tol),
                         __fsub_rn(r.z, a.tol), __fadd_rn(r.w, a.tol));
    }
    case K_EBS_HOP: {
      const float4 r = rect(a, d, c);
      const float* ph = a.phasors + (size_t)g * NPH + 16;
      return make_float4(__fdiv_rn(a.nx, __fsub_rn(r.y, r.x)),
                         __fdiv_rn(a.ny, __fsub_rn(r.w, r.z)), ph[0], ph[1]);
    }
    default:
      return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
cell_rows_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  int* tab = reinterpret_cast<int*>(smem + BUFS * TILE * PITCH);
  unsigned char* och = reinterpret_cast<unsigned char*>(tab + 4 * MAX_B);
  unsigned char* okd = och + CHUNKS;
  __shared__ int warp_count[CHUNKS / 32 + 1];
  const int tid = threadIdx.x;
  ROWS_BEGIN();

  // the branch table, and the row's scalar and zero chunks in ascending
  // order (a ballot a warp of chunks)
  for (int k = tid; k < 4 * a.B; k += THREADS) tab[k] = a.table[k];
  const int q = tid;
  const int kind = q < CHUNKS ? chunk_kind(q, a.num_fc, a.num_oc) : K_JONES;
  const unsigned keep = __ballot_sync(0xffffffffu, kind != K_JONES);
  if (q < CHUNKS && (q & 31) == 0) warp_count[q >> 5] = __popc(keep);
  __syncthreads();
  int n_other = 0, before = 0;
  for (int w = 0; w <= (CHUNKS - 1) / 32; ++w) {
    if (w == (q >> 5)) before = n_other;
    n_other += warp_count[w];
  }
  if (q < CHUNKS && kind != K_JONES) {
    const int at = before + __popc(keep & ((1u << (q & 31)) - 1u));
    och[at] = (unsigned char)q;
    okd[at] = (unsigned char)kind;
  }
  __syncthreads();

  const int r0 = (int)((long long)blockIdx.x * a.total / gridDim.x);
  const int r1 = (int)((long long)(blockIdx.x + 1) * a.total / gridDim.x);
  int t = 0;
  for (int base = r0; base < r1; base += TILE, ++t) {
    float* buf = smem + (t & 1) * TILE * PITCH;
    const int n = min(TILE, r1 - base);
    // the tile's items, rows fastest: (branch, row) for the Jones chunks,
    // then (scalar or zero chunk, row), in one pass
    const int nj = a.B * n;
    for (int it = tid; it < nj + n_other * n; it += THREADS) {
      if (it < nj) {
        const int b = it / n, i = it - b * n;
        int d, c, g;
        row_of(a, base + i, d, c, g);
        const int* tb = tab + 4 * b;
        float4 lo, hi;
        jones(a, tb, b, d, c, lo, hi);
        float4* dst = reinterpret_cast<float4*>(buf + i * PITCH + tb[3]);
        dst[0] = lo;
        dst[1] = hi;
      } else {
        const int j = (it - nj) / n, i = it - nj - j * n;
        int d, c, g;
        row_of(a, base + i, d, c, g);
        reinterpret_cast<float4*>(buf + i * PITCH)[och[j]] =
            other_chunk(a, okd[j], d, c, g);
      }
    }
    fence_async_shared();
    ROWS_MARK(1);
    // the other buffer's copies (the previous tile's) have read it, so the
    // next tile may stage there once every thread is past this barrier
    if (tid < TILE) bulk_wait_read();
    __syncthreads();
    ROWS_MARK(2);
    // thread i sends row i
    if (tid < n) {
      int d, c, g;
      row_of(a, base + tid, d, c, g);
      bulk_store(a.rows + (size_t)g * PC, buf + tid * PITCH, ROW_BYTES);
      bulk_commit();
    }
    ROWS_MARK(3);
  }
  if (tid < TILE) bulk_wait();
  ROWS_END();
}

std::mutex setup_mutex;
bool setup_done = false;
int setup_sms = 0, setup_blocks_per_sm = 0;

// the kernel's shared-memory attribute and the card's resident blocks,
// once a process
cudaError_t rows_setup() {
  std::lock_guard<std::mutex> hold(setup_mutex);
  if (setup_done) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&setup_sms,
                                 cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        cell_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &setup_blocks_per_sm, cell_rows_kernel, THREADS, SMEM);
  if (err == cudaSuccess && setup_blocks_per_sm < 1)
    err = cudaErrorInvalidValue;
  setup_done = err == cudaSuccess;
  return err;
}

// the grid for `total` rows: a block per TILE rows, at most the card's
// resident blocks (engine/cell_rows.py::rows_grid)
long long rows_grid(long long total) {
  const long long tiles = (total + TILE - 1) / TILE;
  const long long resident = (long long)setup_blocks_per_sm * setup_sms;
  return tiles < resident ? tiles : resident;
}

}  // namespace

// The launch shape for `total` rows on this card: out[10] = grid, threads,
// rows a tile, staging buffers, dynamic shared bytes, resident blocks per
// SM, SMs, registers, local bytes a thread, the staged row's pitch in
// floats.  Returns a cudaError_t code (0: read).
extern "C" int cell_rows_shape(long long total, int* out) {
  cudaError_t err = rows_setup();
  cudaFuncAttributes attr;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attr, cell_rows_kernel);
  if (err != cudaSuccess) return (int)err;
  const int v[10] = {(int)rows_grid(total), THREADS, TILE, BUFS, SMEM,
                     setup_blocks_per_sm, setup_sms, attr.numRegs,
                     (int)attr.localSizeBytes, PITCH};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

// Launch on `stream`: (D * C) cell rows from the inputs (layouts as in Args).
// Returns a cudaError_t code (0: launched).
extern "C" int cell_rows_launch(
    const void* branch, const void* table, const void* cosines,
    const void* glass, const void* gaps, const void* phasors,
    const void* eyebox, void* rows, int D, int C, int MN, int B, int num_fc,
    int num_oc, int ny, int nx, float tol, void* stream) {
  const long long total = (long long)D * C;
  if (total <= 0) return 0;
  if (C <= 0 || MN <= 0 || C % MN != 0 || num_fc < 0 || num_fc > MAX_FC ||
      num_oc < 0 || num_oc > MAX_OC || B != 6 + 4 * num_fc + 6 * num_oc ||
      total > 2147483647LL ||
      reinterpret_cast<unsigned long long>(rows) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = rows_setup();
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.branch = static_cast<const double*>(branch);
  a.table = static_cast<const int*>(table);
  a.cosines = static_cast<const double*>(cosines);
  a.glass = static_cast<const double*>(glass);
  a.gaps = static_cast<const double*>(gaps);
  a.phasors = static_cast<const float*>(phasors);
  a.eyebox = static_cast<const double*>(eyebox);
  a.rows = static_cast<float*>(rows);
  a.total = (int)total;
  a.D = D;
  a.C = C;
  a.MN = MN;
  a.B = B;
  a.num_fc = num_fc;
  a.num_oc = num_oc;
  a.ny = (float)ny;
  a.nx = (float)nx;
  a.tol = tol;
  const unsigned grid = (unsigned)rows_grid(total);
  cell_rows_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      a);
  return (int)cudaGetLastError();
}

extern "C" const char* cell_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
