// Row layouts and device helpers shared by the trace kernels
// (persistent_trace.cu, cell_trace.cu).  Every function is float32 with sums
// associated left to right, as in the kernels' plain PyTorch versions; build
// with -fmad=false so that no multiply-add is contracted.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_EDGES = 24;
constexpr int PC = 704;
constexpr int PG = 320;
constexpr int ZPAD = 8;  // zero floats after the cell row: "no record"

// cell row layout (engine/trace_rows.py)
constexpr int INIT_JA = 0, INIT_JB = 8, INIT_SA = 16, INIT_SB = 17,
              INIT_COS0 = 18, OC_SOUT = 19, GAPS = 20, TIR_PH = 28,
              HOP2_PH = 36, EBR = 44, IC_BLK = 48, IC_SA = 80, IC_SB = 81,
              FC_BLK = 96, FC_STRIDE = 36, OC_BLK = 352, OC_STRIDE = 56,
              EBT = 688, EBS = 692, HOP2_ANG = 694;
// geometry row layout
constexpr int G_FC_ROT = 0, G_FC_TOP = 2, G_FC_INVW = 3, G_OC_ROT = 4,
              G_OC_TOP = 6, G_OC_INVW = 7, G_IC = 12, G_HULL = 16, G_R1 = 88,
              G_R2 = 160, G_MC_HULL = 232, G_MC_R1 = 256, G_MC_R2 = 280,
              G_OC_BT = 304;

__device__ __forceinline__ uint32_t xorshift32(uint32_t s) {
  s ^= s << 13;
  s ^= s >> 17;
  s ^= s << 5;
  return s;
}

__device__ __forceinline__ float draw24(uint32_t s) {
  return (float)(int)(s >> 8) * (1.0f / 16777216.0f);
}

// 2x2 complex matvec, coefficients re/im interleaved row-major.  The sums
// associate left to right, as in the plain version.
__device__ __forceinline__ void jones(const float* j, float ter, float tei,
                                      float tmr, float tmi, float o[4]) {
  o[0] = j[0] * ter - j[1] * tei + j[2] * tmr - j[3] * tmi;
  o[1] = j[0] * tei + j[1] * ter + j[2] * tmi + j[3] * tmr;
  o[2] = j[4] * ter - j[5] * tei + j[6] * tmr - j[7] * tmi;
  o[3] = j[4] * tei + j[5] * ter + j[6] * tmi + j[7] * tmr;
}

__device__ __forceinline__ float power4(const float o[4]) {
  return o[0] * o[0] + o[1] * o[1] + o[2] * o[2] + o[3] * o[3];
}

__device__ __forceinline__ float rsqrt_ieee(float v) {
  return 1.0f / sqrtf(fmaxf(v, 1e-30f));
}

__device__ __forceinline__ int bin_index(float v, int hi) {
  return (int)fminf(fmaxf(floorf(v), 0.0f), (float)hi);
}

__device__ __forceinline__ bool region(const float* g, int base, int n,
                                       float x, float y) {
  for (int e = 0; e < n; ++e) {
    if (!(x * g[base + e] + y * g[base + MAX_EDGES + e] <=
          g[base + 2 * MAX_EDGES + e]))
      return false;
  }
  return true;
}

__device__ __forceinline__ bool in_ic(const float* g, float px, float py) {
  float dx = px - g[G_IC];
  float dy = py - g[G_IC + 1];
  return dx * dx + dy * dy <= g[G_IC + 2];
}

}  // namespace
