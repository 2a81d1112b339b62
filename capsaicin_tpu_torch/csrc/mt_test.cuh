// The ray-triangle pair test of K1 static_trace and K8 brute_trace, and the
// loop over a tile of triangles in shared memory that both run.
//
// A pair is tested in three stages, each entered by a warp only where one
// of its lanes needs it (coherent rays skip most of the later ones):
// (1) p = d x e2, det, tv = o - v0 and u's numerator, and the division-free
// prefilter of det and u; (2) q = tv x e1, the numerators of v and t and the
// prefilter of v, u + v and t; (3) the exact test of the plain versions
// (ops/static.py:static_trace_plain, ops/traverse.py:_mt_single) on the
// numerators already computed: the IEEE reciprocal of det, u, v, t, and the
// strict tmin < t < t_best, so the results are bit-equal and ties go to the
// lowest index.
//
// The prefilter multiplies each numerator by an approximate reciprocal of
// det (one rcp.approx.ftz, within 2^-22 of 1/det) and rejects a pair only
// where the exact test must fail whatever the rounding: u or v below -1e-30
// (an exact u that rounds to -0.0 passes u >= 0, and is kept), and where
// |det| < 2^126 (above it the reciprocal may flush to 0), u + v above
// 1 + 2^-14, t beyond tmin or t_best by 2^-14 of |t|; the exact values lie
// within 2^-19 of the approximate ones. Where a numerator is NaN or det is
// not finite no compare rejects, and the exact test decides.
//
// Built with --fmad=false: an FMA would change det/u/v by an ulp and flip
// hits on triangle edges against the plain versions (the prefilter's two
// margins use __fmaf_rn; nothing exact depends on them).
//
// A tile holds each triangle as three float4s (v0, e1, e2; w unused),
// padded to a multiple of MT_STEP with degenerate triangles (all zero: det
// = 0, or NaN for a non-finite ray, never a hit).
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#define MT_STEP 4                   // triangles a step of the tile loop
#define MT_MARGIN 6.103515625e-05f  // 2^-14, the prefilter's relative margin
#define MT_TINY 1e-30f              // and its absolute one
#define MT_SUM_HI 1.00006103515625f  // 1 + 2^-14
#define MT_DET_HI 8.50705917e+37f    // 2^126

// One MUFU.RCP: within 2^-22 of 1/x where that is a normal float, 0 where
// it is below 2^-126 (flushed), so only |det| < 2^126 may reject on
// magnitude (MT_DET_HI); its sign is always right.
__device__ __forceinline__ float mt_rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The prefilter's bound above t_best: at least t_best + 2^-147 (so a t
// rejected above it is above t_best however it rounds), +inf for +inf.
__device__ __forceinline__ float mt_t_hi(float t_best) {
  return __fadd_ru(__fmaf_ru(fabsf(t_best), 9.5367431640625e-07f, t_best), MT_TINY);
}

// The prefilter's bound below tmin, on the host: at most tmin - 2^-147, so
// a t rejected below it is below tmin however it rounds.
static inline float mt_tmin_lo(float tmin) {
  const double lo = (double)tmin - fabs((double)tmin) * 9.5367431640625e-07 - 1e-30;
  float f = (float)lo;
  if ((double)f > lo) f = nextafterf(f, -INFINITY);
  return f;
}

struct MtRay {
  float ox, oy, oz, dx, dy, dz;
};

// One live ray against the n_pad triangles of a tile (n_pad a multiple of
// MT_STEP) in index order, each pair in the three stages; triangle k of the
// tile is prim base + k. Where the plain version accepts a pair (tmin < t <
// t_best), it becomes the best hit (t_best, bu, bv, prim; closest-hit, t_hi
// follows t_best). Returns true where an any-hit ray has hit: it stops
// there. (The stages are written into the loop, so that a rejected pair
// continues it and an any-hit returns from the accepting branch: a
// function a pair with the caller testing prim cost K1 1-2% on its any-hit
// sets.)
template <bool ANY>
__device__ __forceinline__ bool mt_tile(const float4* __restrict__ tile, int n_pad, int base,
                                        const MtRay& r, float tmin, float tmin_lo,
                                        float& t_best, float& t_hi, float& bu, float& bv,
                                        int& prim) {
  for (int k0 = 0; k0 < n_pad; k0 += MT_STEP) {
#pragma unroll
    for (int j = 0; j < MT_STEP; ++j) {
      const int k = k0 + j;
      const float4 v0 = tile[3 * k], e1 = tile[3 * k + 1], e2 = tile[3 * k + 2];
      // (1) the plain version's p, det, tv and u's numerator, in its order
      const float px = r.dy * e2.z - r.dz * e2.y;
      const float py = r.dz * e2.x - r.dx * e2.z;
      const float pz = r.dx * e2.y - r.dy * e2.x;
      const float det = e1.x * px + e1.y * py + e1.z * pz;
      const float tvx = r.ox - v0.x, tvy = r.oy - v0.y, tvz = r.oz - v0.z;
      const float un = tvx * px + tvy * py + tvz * pz;
      const float rcp = mt_rcp_approx(det);
      const float au = un * rcp;
      if (!(fabsf(det) > 1e-12f) || au < -MT_TINY) continue;
      // (2) q and the numerators of v and t
      const float qx = tvy * e1.z - tvz * e1.y;
      const float qy = tvz * e1.x - tvx * e1.z;
      const float qz = tvx * e1.y - tvy * e1.x;
      const float vn = r.dx * qx + r.dy * qy + r.dz * qz;
      const float tn = e2.x * qx + e2.y * qy + e2.z * qz;
      const float av = vn * rcp, at = tn * rcp;
      if (av < -MT_TINY ||
          (fabsf(det) < MT_DET_HI &&
           (au + av > MT_SUM_HI || __fmaf_rn(MT_MARGIN, fabsf(at), at) < tmin_lo ||
            __fmaf_rn(-MT_MARGIN, fabsf(at), at) > t_hi)))
        continue;
      // (3) the exact test
      const float inv_det = 1.0f / det;
      const float uu = un * inv_det;
      const float vv = vn * inv_det;
      const float tt = tn * inv_det;
      if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin && tt < t_best) {
        t_best = tt;
        bu = uu;
        bv = vv;
        prim = base + k;
        if (ANY) return true;
        t_hi = mt_t_hi(tt);
      }
    }
  }
  return false;
}
