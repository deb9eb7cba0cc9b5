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
// [start, end) column runs.  One block stages one image in shared memory
// (multiplied by the image's scale, when given, as the plain version scales
// before it sums); one thread per output adds the disc's bins row-major into
// one float32 accumulator, the plain version's order, so the two agree bit
// for bit.  Bound: the images' bytes, read once (the adds are ~0.1 of it).
//
// colorimetry_partials / colorimetry_finish: (D, 3, fy*fx, P) perception
// stacks -> per design mean CIEDE2000 against D65, the sum over positions of
// min / max of Y, the per-position mean of Y (starved positions 0) and, with
// an image buffer, the eye views (D, fy*fx, 3, P) normalised by each
// position's peak.  The arithmetic is the plain version's, operation for
// operation in its order, with the constants the plain version rounds to
// float32 (the 3 x 3 products written out, no contraction: -fmad=false).
// A block is 32 positions (the lanes: coalesced reads and image writes)
// by 8 groups of pixels; the pixels of a position are split over S blocks
// so that a stack of 56 positions fills the card.  Sums run in a fixed
// order: per thread over its pixels, a fixed tree over the 8 groups, then
// the S partials in order (colorimetry_finish), then over positions in the
// design's last block (a block-wide fixed tree; the last block is found by
// an integer atomic ticket).  Min, max and "any Y = 0" are exact in any
// order.  A run repeats itself bit for bit, and a design's results do not
// depend on the other designs of its launch.  Bound: bytes (the stack read
// once, the image written once); the per-pixel transcendentals are far
// below the card's float32 rate.

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

// ---- perception ----------------------------------------------------------

constexpr int SUM_THREADS = 256;
constexpr int MAX_DISC_ROWS = 128;
constexpr int MAX_STATIC_SMEM = 48 * 1024;

struct Disc {
  int rows;                  // window rows
  int start[MAX_DISC_ROWS];  // per row: first column of the run
  int end[MAX_DISC_ROWS];    // per row: one past its last column
};

struct Window {
  const float* images;       // image b, row y, column x at
                             // b * image_stride + y * row_stride + x
  const float* scale;        // (B,) or null
  float* out;                // (B, epy, epx)
  long long image_stride;
  int row_stride, eby, ebx, epy, epx, sy, sx;
};

__global__ void __launch_bounds__(SUM_THREADS)
pupil_window_sum(const Window w, const Disc disc) {
  extern __shared__ float img[];   // eby * ebx
  const long long b = blockIdx.x;
  const float* src = w.images + b * w.image_stride;
  const int n = w.eby * w.ebx;
  if (w.scale) {
    const float f = w.scale[b];
    for (int k = threadIdx.x; k < n; k += SUM_THREADS) {
      const int y = k / w.ebx;
      img[k] = src[(long long)y * w.row_stride + (k - y * w.ebx)] * f;
    }
  } else {
    for (int k = threadIdx.x; k < n; k += SUM_THREADS) {
      const int y = k / w.ebx;
      img[k] = src[(long long)y * w.row_stride + (k - y * w.ebx)];
    }
  }
  __syncthreads();
  const int nout = w.epy * w.epx;
  float* dst = w.out + b * nout;
  for (int o = threadIdx.x; o < nout; o += SUM_THREADS) {
    const int iy = o / w.epx;
    const int ix = o - iy * w.epx;
    const float* base = img + iy * w.sy * w.ebx + ix * w.sx;
    float acc = 0.0f;
    for (int dy = 0; dy < disc.rows; ++dy) {
      const float* r = base + dy * w.ebx;
      for (int dx = disc.start[dy]; dx < disc.end[dy]; ++dx) acc += r[dx];
    }
    dst[o] = acc;
  }
}

// ---- colorimetry ---------------------------------------------------------

constexpr int LANES = 32;    // positions per block
constexpr int GROUPS = 8;    // pixel groups per block
constexpr int COLOR_THREADS = LANES * GROUPS;

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

struct Color {
  const float* perc;   // (D, 3, npix, P), (B, G, R) wavelength order
  float* image;        // (D, npix, 3, P) or null
  float* part;         // (D, S, NPART, P)
  float* pos;          // (D, 2, P): delta E sum and min / max ratio
  int* done;           // (D,): position blocks finished, zeroed per launch
  float* delta_e;      // (D,)
  float* ratio_sum;    // (D,)
  float* u_eb;         // (D, P)
  float inv_norm;
  int npix, P, S, chunk, chunk2;
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

__global__ void __launch_bounds__(COLOR_THREADS)
colorimetry_partials(const Color a, const Consts k) {
  __shared__ float red[NPART][GROUPS][LANES];
  const float* c = k.c;
  const int d = blockIdx.z, s = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p = blockIdx.x * LANES + tx;
  float de = 0.0f, ys = 0.0f, ymin = INFINITY, ymax = -INFINITY;
  float zero = 0.0f, peak = -INFINITY;
  if (p < a.P) {
    const size_t plane = (size_t)a.npix * a.P;
    const float* src = a.perc + (size_t)d * 3 * plane + p;
    const int i1 = min(a.npix, (s + 1) * a.chunk);
    for (int i = s * a.chunk + ty; i < i1; i += GROUPS) {
      const size_t o = (size_t)i * a.P;
      // the (B, G, R) histogram order flipped to (R, G, B), each scaled by
      // 1 / norm, then by the drive
      float ep[3];
      for (int j = 0; j < 3; ++j)
        ep[j] = c[K_DRIVE + j] * (src[o + (2 - j) * plane] * a.inv_norm);
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
  __syncthreads();
  if (ty != 0 || p >= a.P) return;
  float v[GROUPS];
  float* out = a.part + ((size_t)d * a.S + s) * NPART * a.P + p;
  for (int q = 0; q < NPART; ++q) {
    for (int g = 0; g < GROUPS; ++g) v[g] = red[q][g][tx];
    float r = v[0];
    if (q == P_DE || q == P_Y) {
      r = sum8(v);
    } else {
      for (int g = 1; g < GROUPS; ++g)
        r = q == P_YMIN ? fminf(r, v[g]) : fmaxf(r, v[g]);
    }
    out[(size_t)q * a.P] = r;
  }
}

__global__ void __launch_bounds__(COLOR_THREADS)
colorimetry_finish(const Color a) {
  __shared__ float red[2][COLOR_THREADS];
  __shared__ int last;
  const int d = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int p = blockIdx.x * LANES + tx;
  const float* part = a.part + (size_t)d * a.S * NPART * a.P + p;
  const size_t stride = (size_t)NPART * a.P;
  if (a.image && p < a.P) {
    float peak = -INFINITY;
    for (int s = 0; s < a.S; ++s)
      peak = fmaxf(peak, part[s * stride + (size_t)P_PEAK * a.P]);
    if (peak > 0.0f) {
      const int n3 = 3 * a.npix;
      float* img = a.image + (size_t)d * n3 * a.P + p;
      const int e1 = min(n3, (blockIdx.y + 1) * a.chunk2);
      for (int e = blockIdx.y * a.chunk2 + ty; e < e1; e += GROUPS)
        img[(size_t)e * a.P] = img[(size_t)e * a.P] / peak;
    }
  }
  if (blockIdx.y != 0) return;
  if (ty == 0 && p < a.P) {
    float de = 0.0f, ys = 0.0f, ymin = INFINITY, ymax = -INFINITY;
    float zero = 0.0f;
    for (int s = 0; s < a.S; ++s) {
      const float* q = part + s * stride;
      de += q[(size_t)P_DE * a.P];
      ys += q[(size_t)P_Y * a.P];
      ymin = fminf(ymin, q[(size_t)P_YMIN * a.P]);
      ymax = fmaxf(ymax, q[(size_t)P_YMAX * a.P]);
      zero = fmaxf(zero, q[(size_t)P_ZERO * a.P]);
    }
    const bool starved = zero != 0.0f;
    a.u_eb[(size_t)d * a.P + p] = starved ? 0.0f : ys / (float)a.npix;
    a.pos[(size_t)d * 2 * a.P + p] = de;
    a.pos[((size_t)d * 2 + 1) * a.P + p] =
        starved ? 0.0f : ymin / (ymax > 0.0f ? ymax : 1.0f);
    __threadfence();
  }
  __syncthreads();
  const int t = ty * LANES + tx;
  if (t == 0) last = atomicAdd(a.done + d, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the design's last position block: sum over positions, fixed order
  const float* pos = a.pos + (size_t)d * 2 * a.P;
  float de = 0.0f, ratio = 0.0f;
  for (int i = t; i < a.P; i += COLOR_THREADS) {
    de += __ldcg(pos + i);
    ratio += __ldcg(pos + a.P + i);
  }
  red[0][t] = de;
  red[1][t] = ratio;
  __syncthreads();
  for (int w = COLOR_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      red[0][t] += red[0][t + w];
      red[1][t] += red[1][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    a.delta_e[d] = red[0][0] / (float)((long long)a.P * a.npix);
    a.ratio_sum[d] = red[1][0];
  }
}

}  // namespace

// Load the module now, not at the first launch: the function attributes
// are read from each kernel (a lazily loaded module loads here).  Returns a
// cudaError_t code (0: loaded).
extern "C" int eye_tail_prepare(void) {
  cudaFuncAttributes attr;
  const void* fns[] = {(const void*)pupil_window_sum,
                       (const void*)colorimetry_partials,
                       (const void*)colorimetry_finish};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Launch on `stream`: out (B, epy, epx) = the disc's window sums of B images
// (image b at images + b * image_stride, rows row_stride apart), each first
// multiplied by scale[b] when scale is not null.  The disc: `rows` rows,
// row r covering columns [segments[2r], segments[2r + 1]) (host array).
// Returns a cudaError_t code (0: launched).
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
  Window w;
  w.images = static_cast<const float*>(images);
  w.scale = static_cast<const float*>(scale);
  w.out = static_cast<float*>(out);
  w.image_stride = image_stride;
  w.row_stride = row_stride;
  w.eby = eby;
  w.ebx = ebx;
  w.epy = (eby - rows) / sy + 1;
  w.epx = (ebx - cols) / sx + 1;
  w.sy = sy;
  w.sx = sx;
  const size_t smem = (size_t)eby * ebx * sizeof(float);
  if (smem > MAX_STATIC_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        pupil_window_sum, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  pupil_window_sum<<<B, SUM_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(w, disc);
  return (int)cudaGetLastError();
}

// Launch on `stream`: the colorimetry of D (3, npix, P) stacks.  `image`
// may be null (no eye views).  Scratch: part (D * S * 6 floats), pos (D * 2
// * P floats), done (D ints, zeroed here).  consts: the NCONST float32
// constants (host array).  S splits of `chunk` pixels; the image's 3 * npix
// entries of a position in splits of `chunk2`.  Returns a cudaError_t code
// (0: launched).
extern "C" int colorimetry_launch(
    const void* perc, void* image, void* part, void* pos, void* done,
    void* delta_e, void* ratio_sum, void* u_eb, const float* consts,
    int nconst, float inv_norm, int D, int npix, int P, int S, int chunk,
    int chunk2, void* stream) {
  if (D <= 0) return 0;
  if (nconst != NCONST || npix <= 0 || P <= 0 || S <= 0 || chunk <= 0 ||
      (long long)S * chunk < npix || chunk2 <= 0)
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
  a.chunk2 = chunk2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(int) * D, st);
  if (err != cudaSuccess) return (int)err;
  const unsigned tiles = (unsigned)((P + LANES - 1) / LANES);
  const dim3 block(LANES, GROUPS);
  colorimetry_partials<<<dim3(tiles, S, D), block, 0, st>>>(a, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned splits2 =
      image ? (unsigned)((3LL * npix + chunk2 - 1) / chunk2) : 1u;
  colorimetry_finish<<<dim3(tiles, splits2, D), block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* eye_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
