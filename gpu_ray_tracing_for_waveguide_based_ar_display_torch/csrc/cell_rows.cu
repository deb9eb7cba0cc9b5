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
// Design: one block owns a tile of TILE consecutive cell rows and stages
// them in shared memory (TILE * 704 floats, zeroed first, so every padding
// column is 0).  Its threads walk the (branch, cell) items branch-major, so
// neighbouring threads read neighbouring cells of one branch's inputs
// (coalesced float64 loads), and write each item's 8 floats of Jones
// matrix into the staged rows; one thread per cell writes the scalar
// columns.  The tile then goes out as contiguous float4 stores: the rows of
// a tile are one contiguous run of device memory.  What bounds it: the
// bytes written (the rows, 2,816 B a cell) and read (the branch inputs,
// 56 B per branch and cell, read once per design); the float64 division and
// square root of each item are a few dozen instructions, far below the
// card's float64 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the row layout of engine/trace_rows.py
constexpr int PC = 704;
constexpr int INIT_SA = 16, INIT_SB = 17, INIT_COS0 = 18, OC_SOUT = 19;
constexpr int GAPS = 20, TIR_PH = 28, EBR = 44, IC_SA = 80, IC_SB = 81;
constexpr int FC_BLK = 96, FC_STRIDE = 36, OC_BLK = 352, OC_STRIDE = 56;
constexpr int EBT = 688, EBS = 692, HOP2_ANG = 694;
constexpr int MAX_FC = (OC_BLK - FC_BLK) / FC_STRIDE;  // 7
constexpr int MAX_OC = (EBT - OC_BLK) / OC_STRIDE;     // 6

constexpr int TILE = 16;      // cell rows per block: 45,056 B of shared memory
constexpr int THREADS = 256;
constexpr int NCOS = 5;       // angle cosines: air, ic, ic2, fc, oc
constexpr int NPH = 18;       // TIR and hop-2 phasors (re, im) x 4, 2 angles

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
  long long total;        // D * C
  int C, MN, B, num_fc, num_oc;
  float ny, nx, tol;
};

// a float64 times a complex128 as numpy computes it: (a, 0) * (br, bi)
__device__ __forceinline__ void real_times_complex(double a, double br,
                                                   double bi, double& re,
                                                   double& im) {
  re = __dsub_rn(__dmul_rn(a, br), __dmul_rn(0.0, bi));
  im = __dadd_rn(__dmul_rn(a, bi), __dmul_rn(0.0, br));
}

__global__ void __launch_bounds__(THREADS)
cell_rows_kernel(const Args a) {
  __shared__ __align__(16) float tile[TILE * PC];
  const long long g0 = (long long)blockIdx.x * TILE;
  const int n = (int)min((long long)TILE, a.total - g0);
  for (int k = threadIdx.x; k < TILE * PC; k += THREADS) tile[k] = 0.0f;
  __syncthreads();

  // Jones matrices: item = branch * TILE + row of the tile
  for (int item = threadIdx.x; item < a.B * TILE; item += THREADS) {
    const int b = item / TILE, i = item - b * TILE;
    if (i >= n) continue;
    const long long g = g0 + i;
    const int d = (int)(g / a.C), c = (int)(g - (long long)d * a.C);
    const double* br = a.branch + (size_t)b * 7 * a.C + c;
    const double p = br[0], cb = br[(size_t)a.C], sb = br[(size_t)2 * a.C];
    const double e1r = br[(size_t)3 * a.C], e1i = br[(size_t)4 * a.C];
    const double e2r = br[(size_t)5 * a.C], e2i = br[(size_t)6 * a.C];
    const int* t = a.table + 4 * b;
    const double* cd = a.cosines + (size_t)d * NCOS * a.C + c;
    const double cin = cd[(size_t)t[0] * a.C], cout = cd[(size_t)t[1] * a.C];
    const double extra = t[2] == 0 ? 1.0 : a.glass[2 * d + t[2] - 1];
    const double s = __dsqrt_rn(
        __ddiv_rn(__dmul_rn(p, cin), __dmul_rn(cout, extra)));
    // U = [[cb e1, -sb e2], [sb e1, cb e2]], then s * U, row-major (re, im)
    double u[8];
    real_times_complex(cb, e1r, e1i, u[0], u[1]);
    real_times_complex(-sb, e2r, e2i, u[2], u[3]);
    real_times_complex(sb, e1r, e1i, u[4], u[5]);
    real_times_complex(cb, e2r, e2i, u[6], u[7]);
    float* dst = tile + i * PC + t[3];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      double jr, ji;
      real_times_complex(s, u[2 * k], u[2 * k + 1], jr, ji);
      dst[2 * k] = __double2float_rn(jr);
      dst[2 * k + 1] = __double2float_rn(ji);
    }
  }

  // the scalar columns, one thread per row
  if (threadIdx.x < n) {
    const int i = threadIdx.x;
    const long long g = g0 + i;
    const int d = (int)(g / a.C), c = (int)(g - (long long)d * a.C);
    float* row = tile + i * PC;
    const double* cd = a.cosines + (size_t)d * NCOS * a.C + c;
    const float air = __double2float_rn(cd[0]);
    const float ic = __double2float_rn(cd[(size_t)a.C]);
    const float ic2 = __double2float_rn(cd[(size_t)2 * a.C]);
    const float fc = __double2float_rn(cd[(size_t)3 * a.C]);
    const float oc = __double2float_rn(cd[(size_t)4 * a.C]);
    const float ng = __double2float_rn(a.glass[2 * d]);
    row[INIT_SA] = __fmul_rn(ic, ng);
    row[INIT_SB] = __fmul_rn(ic2, ng);
    row[INIT_COS0] = air;
    row[OC_SOUT] = __fdiv_rn(air, ng);
    const double* gp = a.gaps + (size_t)g * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) row[GAPS + k] = __double2float_rn(gp[k]);
    const float* ph = a.phasors + (size_t)g * NPH;
#pragma unroll
    for (int k = 0; k < 16; ++k) row[TIR_PH + k] = ph[k];
    row[HOP2_ANG] = ph[16];
    row[HOP2_ANG + 1] = ph[17];
    const double* eb = a.eyebox + ((size_t)d * a.MN + c % a.MN) * 4;
    float r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      r[k] = __double2float_rn(eb[k]);
      row[EBR + k] = r[k];
    }
    row[EBT + 0] = __fsub_rn(r[0], a.tol);
    row[EBT + 1] = __fadd_rn(r[1], a.tol);
    row[EBT + 2] = __fsub_rn(r[2], a.tol);
    row[EBT + 3] = __fadd_rn(r[3], a.tol);
    row[EBS + 0] = __fdiv_rn(a.nx, __fsub_rn(r[1], r[0]));
    row[EBS + 1] = __fdiv_rn(a.ny, __fsub_rn(r[3], r[2]));
    row[IC_SA] = ic;
    row[IC_SB] = ic2;
    for (int s = 0; s < a.num_fc; ++s) {
      row[FC_BLK + s * FC_STRIDE + 32] = ic;
      row[FC_BLK + s * FC_STRIDE + 33] = fc;
    }
    for (int s = 0; s < a.num_oc; ++s) {
      row[OC_BLK + s * OC_STRIDE + 48] = fc;
      row[OC_BLK + s * OC_STRIDE + 49] = oc;
    }
  }
  __syncthreads();

  // the tile's rows are contiguous in device memory (PC * 4 B = 176 float4)
  float4* out = reinterpret_cast<float4*>(a.rows + (size_t)g0 * PC);
  const float4* src = reinterpret_cast<const float4*>(tile);
  for (int k = threadIdx.x; k < n * (PC / 4); k += THREADS) out[k] = src[k];
}

}  // namespace

// Launch on `stream`: (D * C) cell rows from the inputs (layouts as in Args).
// Returns a cudaError_t code (0: launched).
extern "C" int cell_rows_launch(
    const void* branch, const void* table, const void* cosines,
    const void* glass, const void* gaps, const void* phasors,
    const void* eyebox, void* rows, int D, int C, int MN, int B, int num_fc,
    int num_oc, int ny, int nx, float tol, void* stream) {
  const long long total = (long long)D * C;
  if (total <= 0) return 0;
  if (C <= 0 || MN <= 0 || C % MN != 0 || B <= 0 || num_fc < 0 ||
      num_fc > MAX_FC || num_oc < 0 || num_oc > MAX_OC ||
      (total + TILE - 1) / TILE > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.branch = static_cast<const double*>(branch);
  a.table = static_cast<const int*>(table);
  a.cosines = static_cast<const double*>(cosines);
  a.glass = static_cast<const double*>(glass);
  a.gaps = static_cast<const double*>(gaps);
  a.phasors = static_cast<const float*>(phasors);
  a.eyebox = static_cast<const double*>(eyebox);
  a.rows = static_cast<float*>(rows);
  a.total = total;
  a.C = C;
  a.MN = MN;
  a.B = B;
  a.num_fc = num_fc;
  a.num_oc = num_oc;
  a.ny = (float)ny;
  a.nx = (float)nx;
  a.tol = tol;
  const unsigned grid = (unsigned)((total + TILE - 1) / TILE);
  cell_rows_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* cell_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
