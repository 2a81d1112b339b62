// K1 static_trace: closest-hit and any-hit ray queries against a small
// scene (at most 128 triangles), by brute force.
//
// Replaces capsaicin_tpu/ops/pallas_static.py:_static_kernel, which
// unrolls every triangle test over 8x128-ray tiles in VMEM.
//
// Bound: the instructions each ray-triangle pair issues, not bytes. A 1080p
// frame traces 2,073,600 rays a call against the Cornell box's 40
// triangles, four calls a frame; memory traffic is 28 B in and 16 B out a
// ray. One thread a ray that ran the whole Moller-Trumbore test on every
// pair issued about 90 warp instructions a pair (nine scalar shared-memory
// reads, the IEEE reciprocal with its range check, about 45 float32
// operations, as --fmad=false keeps them apart, the compares).
//
// Design: one thread a ray, 256 a block; a dead ray (tmax <= tmin) tests
// nothing, an any-hit ray stops at its first hit.
// - The block stages the triangles (v0, e1, e2) in shared memory as three
//   float4s each, padded to a multiple of STATIC_STEP with degenerate
//   triangles (det = 0, never a hit); the loop reads a triangle in three
//   broadcasts and runs STATIC_STEP triangles a step.
// - The test runs in three stages, each entered by a warp only where one of
//   its lanes needs it (coherent rays skip most of the later ones):
//   (1) p = d x e2, det, tv = o - v0 and u's numerator, and the division-free
//   prefilter of det and u; (2) q = tv x e1, the numerators of v and t and
//   the prefilter of v, u + v and t; (3) the exact test of the plain version
//   (static_trace_plain) on the numerators already computed: the IEEE
//   reciprocal of det, u, v, t, and the strict tmin < t < t_best, so the
//   results are bit-equal and ties go to the lowest index.
// - The prefilter multiplies each numerator by an approximate reciprocal
//   of det (one rcp.approx.ftz, within 2^-22 of 1/det) and rejects a pair
//   only where the exact test must fail whatever the rounding: u or v below
//   -1e-30 (an exact u that rounds to -0.0 passes u >= 0, and is kept), and
//   where |det| < 2^126 (above it the reciprocal may flush to 0), u + v
//   above 1 + 2^-14, t beyond tmin or t_best by 2^-14 of |t|; the exact
//   values lie within 2^-19 of the approximate ones. Where a numerator is
//   NaN or det is not finite no compare rejects, and the exact test decides.
// Built with --fmad=false: an FMA would change det/u/v by an ulp and flip
// hits on triangle edges against the plain version (the prefilter's two
// margins use __fmaf_rn; nothing exact depends on them).
#include <cuda_runtime.h>
#include <math.h>

#define STATIC_MAX_TRIS 128
#define STATIC_BLOCK 256
#define STATIC_STEP 4                   // triangles a step of the loop
#define STATIC_MARGIN 6.103515625e-05f  // 2^-14, the prefilter's relative margin
#define STATIC_TINY 1e-30f              // and its absolute one
#define STATIC_SUM_HI 1.00006103515625f  // 1 + 2^-14
#define STATIC_DET_HI 8.50705917e+37f    // 2^126

// One MUFU.RCP: within 2^-22 of 1/x where that is a normal float, 0 where
// it is below 2^-126 (flushed), so only |det| < 2^126 may reject on
// magnitude (STATIC_DET_HI); its sign is always right.
__device__ __forceinline__ float static_rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The prefilter's bound above t_best: at least t_best + 2^-147 (so a t
// rejected above it is above t_best however it rounds), +inf for +inf.
__device__ __forceinline__ float static_t_hi(float t_best) {
  return __fadd_ru(__fmaf_ru(fabsf(t_best), 9.5367431640625e-07f, t_best), STATIC_TINY);
}

template <bool ANY>
__global__ void __launch_bounds__(STATIC_BLOCK)
static_trace_kernel(const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
                    float tmin_lo, const float* __restrict__ tmax, const float* __restrict__ tris,
                    int n_rays, int n_tris, float* __restrict__ t_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int* __restrict__ prim_out,
                    unsigned char* __restrict__ hit_out) {
  __shared__ float4 s_tris[3 * STATIC_MAX_TRIS];  // v0, e1, e2 of each triangle
  const int n_pad = (n_tris + STATIC_STEP - 1) / STATIC_STEP * STATIC_STEP;
  for (int i = threadIdx.x; i < 3 * n_pad; i += STATIC_BLOCK) {
    const float* row = tris + 3 * i;  // triangle i / 3, vector i % 3
    s_tris[i] = i < 3 * n_tris ? make_float4(row[0], row[1], row[2], 0.0f)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const int r = blockIdx.x * STATIC_BLOCK + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = origins[3 * r], oy = origins[3 * r + 1], oz = origins[3 * r + 2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  float t_best = tmax[r];
  float bu = 0.0f, bv = 0.0f;
  int prim = -1;

  if (t_best > tmin) {
    float t_hi = static_t_hi(t_best);
    for (int k0 = 0; k0 < n_pad; k0 += STATIC_STEP) {
#pragma unroll
      for (int j = 0; j < STATIC_STEP; ++j) {
        const int k = k0 + j;
        const float4 v0 = s_tris[3 * k], e1 = s_tris[3 * k + 1], e2 = s_tris[3 * k + 2];
        // (1) the plain version's p, det, tv and u's numerator, in its order
        const float px = dy * e2.z - dz * e2.y;
        const float py = dz * e2.x - dx * e2.z;
        const float pz = dx * e2.y - dy * e2.x;
        const float det = e1.x * px + e1.y * py + e1.z * pz;
        const float tvx = ox - v0.x, tvy = oy - v0.y, tvz = oz - v0.z;
        const float un = tvx * px + tvy * py + tvz * pz;
        const float rcp = static_rcp_approx(det);
        const float au = un * rcp;
        if (!(fabsf(det) > 1e-12f) || au < -STATIC_TINY) continue;
        // (2) q and the numerators of v and t
        const float qx = tvy * e1.z - tvz * e1.y;
        const float qy = tvz * e1.x - tvx * e1.z;
        const float qz = tvx * e1.y - tvy * e1.x;
        const float vn = dx * qx + dy * qy + dz * qz;
        const float tn = e2.x * qx + e2.y * qy + e2.z * qz;
        const float av = vn * rcp, at = tn * rcp;
        if (av < -STATIC_TINY ||
            (fabsf(det) < STATIC_DET_HI &&
             (au + av > STATIC_SUM_HI || __fmaf_rn(STATIC_MARGIN, fabsf(at), at) < tmin_lo ||
              __fmaf_rn(-STATIC_MARGIN, fabsf(at), at) > t_hi)))
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
          prim = k;
          if (ANY) {
            k0 = n_pad;
            break;
          }
          t_hi = static_t_hi(tt);
        }
      }
    }
  }
  if (ANY) {
    hit_out[r] = prim >= 0 ? 1 : 0;
  } else {
    t_out[r] = t_best;
    u_out[r] = bu;
    v_out[r] = bv;
    prim_out[r] = prim;
  }
}

// The prefilter's bound below tmin: at most tmin - 2^-147, so a t rejected
// below it is below tmin however it rounds.
static float static_tmin_lo(float tmin) {
  const double lo = (double)tmin - fabs((double)tmin) * 9.5367431640625e-07 - 1e-30;
  float f = (float)lo;
  if ((double)f > lo) f = nextafterf(f, -INFINITY);
  return f;
}

extern "C" int static_trace(const float* origins, const float* dirs, float tmin,
                            const float* tmax, const float* tris, int n_rays, int n_tris,
                            int any_hit, float* t_out, float* u_out, float* v_out, int* prim_out,
                            unsigned char* hit_out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_tris > STATIC_MAX_TRIS) return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const int grid = (n_rays + STATIC_BLOCK - 1) / STATIC_BLOCK;
    const float lo = static_tmin_lo(tmin);
    if (any_hit)
      static_trace_kernel<true><<<grid, STATIC_BLOCK, 0, stream>>>(
          origins, dirs, tmin, lo, tmax, tris, n_rays, n_tris, t_out, u_out, v_out, prim_out,
          hit_out);
    else
      static_trace_kernel<false><<<grid, STATIC_BLOCK, 0, stream>>>(
          origins, dirs, tmin, lo, tmax, tris, n_rays, n_tris, t_out, u_out, v_out, prim_out,
          hit_out);
  }
  return (int)cudaGetLastError();
}

// K1's build on `device`: registers and local (spilled) bytes a thread,
// static shared bytes a block, 0 dynamic bytes, resident blocks of
// STATIC_BLOCK an SM, SMs.
extern "C" int static_trace_info(int any_hit, int* out, int device) {
  cudaSetDevice(device);
  const void* fn = any_hit ? reinterpret_cast<const void*>(static_trace_kernel<true>)
                           : reinterpret_cast<const void*>(static_trace_kernel<false>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, STATIC_BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = 0;
  out[4] = blocks;
  out[5] = sms;
  return (int)cudaSuccess;
}
