// The step transport of the splitting engines (split_cells.cu, the
// per-cell wavefronts, and split_trace.cu, the global wavefront): a launch
// ray's first in-coupler interaction with both orders as weighted children
// (split_init), a slot's two children with its deposit and pruned weight
// (split_step and its child()), and the wavefront buffer's layout (11
// fields of K slots each, the state as int bits).  Every function is the
// plain PyTorch step (engine/splitting.py::_build_step_fns) in float32 with
// its operations in its order (see step_common.cuh).  A Cell holds the
// tables of one (lambda, FoV) cell entry-major: its records (R2, 26), its
// constants (26,) and its direction rows (4, 6).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "step_common.cuh"

namespace {

constexpr int NF = 11;                // wavefront fields
enum { F_X, F_Y, F_TER, F_TEI, F_TMR, F_TMI, F_COS, F_GX, F_GY, F_ST, F_W };

struct Ray {
  float x, y, ter, tei, tmr, tmi, cos, gx, gy, w;
  int st;
};

// one cell's tables and the geometry (split_cells.cu: in shared memory)
struct Cell : Geom {
  const float* rec;      // (R2, 26): record of key k at k * 26
  const float* cell;     // (26,)
  const float* dirs;     // (4, 6)
  int num_fc, num_oc, ny, nx;
  float thr;
};

// split_init: a launch ray's first in-coupler interaction, both orders
__device__ void init_children(const Cell& c, const float* s, Ray& a, Ray& b,
                              float& pr_a, float& pr_b) {
  const float w0 = fabsf(s[2]) + fabsf(s[3]) + fabsf(s[4]) + fabsf(s[5]);
  const float w = w0 > 0.0f ? 1.0f : 0.0f;
  for (int branch = 0; branch < 2; ++branch) {
    Ray& o = branch == 0 ? a : b;
    const float* jm = c.cell + (branch == 0 ? I_JA : I_JB);
    const float sc = c.cell[branch == 0 ? I_SA : I_SB];
    float p[4];
    jones(jm, s[2], s[3], s[4], s[5], p);
    const float eff = __fdiv_rn(power4(p[0], p[1], p[2], p[3]) * sc,
                                c.cell[I_COS0]);
    const float pw = power4(p[0], p[1], p[2], p[3]);
    const float inv = rsqrt_rn(pw > 1e-30f ? pw : 1.0f);
    const float* d = c.dirs + DIR_W * (branch == 0 ? DIR_IC : DIR_IC2);
    o.ter = p[0] * inv;
    o.tei = p[1] * inv;
    phase_mul(d[2], d[3], p[2] * inv, p[3] * inv, o.tmr, o.tmi);
    o.gx = d[0];
    o.gy = d[1];
    o.x = s[0] + d[0];
    o.y = s[1] + d[1];
    const bool icin = in_ic(c, o.x, o.y);
    int st = branch == 0 ? (icin ? 0 : 2) : (icin ? 1 : DEAD);
    const float wgt = w * eff;
    const bool keep = wgt > c.thr;
    const float killed = (st < DEAD && !keep) ? wgt : 0.0f;
    if (branch == 0) pr_a = killed; else pr_b = killed;
    o.st = keep ? st : DEAD;
    o.cos = c.cell[branch == 0 ? I_ICA : I_ICB];
    o.w = wgt;
  }
}

// one child of split_step's child(): renormalise, phasor, hop, state, weight
__device__ void child(const Cell& c, const Ray& r, const float* bp, float eff,
                      float scale_cos, int dir, int to_fc, int to_oc,
                      int ic_in, int ic_out, bool grp_oc, bool grp_fc,
                      bool interact, bool alive, Ray& o, float& pr) {
  const float pw = power4(bp[0], bp[1], bp[2], bp[3]);
  const float inv = rsqrt_rn(pw > 1e-30f ? pw : 1.0f);
  const float* d = c.dirs + DIR_W * dir;
  o.ter = bp[0] * inv;
  o.tei = bp[1] * inv;
  phase_mul(d[2], d[3], bp[2] * inv, bp[3] * inv, o.tmr, o.tmi);
  o.gx = d[0];
  o.gy = d[1];
  o.x = r.x + d[0];
  o.y = r.y + d[1];
  int st;
  if (grp_oc) st = to_oc;
  else if (grp_fc) st = to_fc;
  else st = in_ic(c, o.x, o.y) ? ic_in : ic_out;
  const float wgt = r.w * eff;
  const bool keep = wgt > c.thr;
  pr = (interact && alive && !keep) ? wgt : 0.0f;
  o.st = (interact && keep) ? st : DEAD;
  o.cos = scale_cos;
  o.w = wgt;
}

// split_step for one slot whose region tests are given: children A and B,
// the deposit (bin or -1, and its weight) and each child's pruned weight
__device__ __forceinline__ void step_children_in(
    const Cell& c, const Ray& r, bool in_r1, bool in_hull, bool in_r2,
    Ray& a, Ray& b, int& dbin, float& dw, float& pr_a, float& pr_b) {
  const float x = r.x, y = r.y;
  const int state = r.st;
  const bool alive = state < DEAD && in_r1;
  // site_key
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

  float pol_a[4], pol_b[4];
  jones(rec, r.ter, r.tei, r.tmr, r.tmi, pol_a);
  jones(rec + 8, r.ter, r.tei, r.tmr, r.tmi, pol_b);
  const float s_a = rec[24], s_b = rec[25];
  const float inv_cos = __fdiv_rn(1.0f, r.cos > 0.0f ? r.cos : 1.0f);
  const float eff_a = power4(pol_a[0], pol_a[1], pol_a[2], pol_a[3]) * s_a
                      * inv_cos;
  const float eff_b = power4(pol_b[0], pol_b[1], pol_b[2], pol_b[3]) * s_b
                      * inv_cos;

  // the deposit: branch C of an out-coupler hit, at the slot's position
  dbin = -1;
  dw = 0.0f;
  if (hit_oc) {
    float pol_c[4];
    jones(rec + 16, r.ter, r.tei, r.tmr, r.tmi, pol_c);
    const float eff_c = power4(pol_c[0], pol_c[1], pol_c[2], pol_c[3])
                        * c.cell[C_SOUT] * inv_cos;
    const float dep_w = r.w * eff_c;
    bool in_quad;
    const int qbin = deposit_bin(c.cell + C_EBR, x, y, c.ny, c.nx,
                                 in_quad);
    if (in_quad && dep_w != 0.0f) {
      dbin = qbin;
      dw = dep_w;
    }
  }

  const bool miss_fc2 = grp_fc && !in_hull && state == 2;
  const bool miss_fc3 = grp_fc && !in_hull && state == 3;
  const bool fc3_to_oc = miss_fc3 && !in_r2;
  const bool hop = miss_fc2 || (miss_fc3 && in_r2)
                   || (grp_oc && !in_rect && state == 4);
  const bool miss_oc5 = grp_oc && !in_rect && state == 5;

  const int dir_a = grp_oc ? DIR_FC : DIR_IC;
  const int dir_b = grp_ic ? DIR_IC2 : (grp_fc ? DIR_FC : DIR_OC);
  child(c, r, pol_a, eff_a, s_a, dir_a, 2, 4, 0, 2, grp_oc, grp_fc,
        interact, alive, a, pr_a);
  child(c, r, pol_b, eff_b, s_b, dir_b, 3, 5, 1, DEAD, grp_oc, grp_fc,
        interact, alive, b, pr_b);

  // a slot that does not interact: child A carries the hop survivor or the
  // phase change
  const bool not_int = alive && !interact;
  if (not_int) {
    const float* hd = c.dirs + DIR_W * (miss_fc2 ? DIR_IC : DIR_FC);
    float hop_tmr, hop_tmi;
    phase_mul(hd[4], hd[5], r.tmr, r.tmi, hop_tmr, hop_tmi);
    a.x = hop ? x + r.gx : x;
    a.y = hop ? y + r.gy : y;
    a.ter = r.ter;
    a.tei = r.tei;
    a.tmr = hop ? hop_tmr : r.tmr;
    a.tmi = hop ? hop_tmi : r.tmi;
    a.cos = r.cos;
    a.gx = r.gx;
    a.gy = r.gy;
    a.w = r.w;
    int surv = fc3_to_oc ? 4 : (hop ? state : DEAD);
    if (miss_oc5) surv = DEAD;
    a.st = surv;
  }
  if (!alive) a.st = DEAD;
  if (!(alive && interact)) b.st = DEAD;
}

// split_step for one slot, its region tests included
__device__ void step_children(const Cell& c, const Ray& r, Ray& a, Ray& b,
                              int& dbin, float& dw, float& pr_a,
                              float& pr_b) {
  bool in_r1, in_hull, in_r2;
  regions(c, r.x, r.y, in_r1, in_hull, in_r2);
  step_children_in(c, r, in_r1, in_hull, in_r2, a, b, dbin, dw, pr_a, pr_b);
}

__device__ __forceinline__ Ray load_ray(const float* src, int K, int i) {
  Ray r;
  r.x = src[F_X * K + i];
  r.y = src[F_Y * K + i];
  r.ter = src[F_TER * K + i];
  r.tei = src[F_TEI * K + i];
  r.tmr = src[F_TMR * K + i];
  r.tmi = src[F_TMI * K + i];
  r.cos = src[F_COS * K + i];
  r.gx = src[F_GX * K + i];
  r.gy = src[F_GY * K + i];
  r.st = __float_as_int(src[F_ST * K + i]);
  r.w = src[F_W * K + i];
  return r;
}

__device__ __forceinline__ void store_ray(float* dst, int K, int i,
                                          const Ray& r) {
  dst[F_X * K + i] = r.x;
  dst[F_Y * K + i] = r.y;
  dst[F_TER * K + i] = r.ter;
  dst[F_TEI * K + i] = r.tei;
  dst[F_TMR * K + i] = r.tmr;
  dst[F_TMI * K + i] = r.tmi;
  dst[F_COS * K + i] = r.cos;
  dst[F_GX * K + i] = r.gx;
  dst[F_GY * K + i] = r.gy;
  dst[F_ST * K + i] = __int_as_float(r.st);
  dst[F_W * K + i] = r.w;
}

}  // namespace
