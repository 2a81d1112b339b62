// K1 static_trace: closest-hit and any-hit ray queries against a small
// scene (at most 128 triangles), by brute force.
//
// Replaces capsaicin_tpu/ops/pallas_static.py:_static_kernel, which
// unrolls every triangle test over 8x128-ray tiles in VMEM.
//
// Bound: arithmetic. Each ray-triangle pair costs about 40 FLOP of
// Moller-Trumbore; a 1080p frame traces 2,073,600 rays per call against
// the Cornell box's 40 triangles, four calls per frame. Memory traffic is
// 32 B in and 16 B out per ray.
//
// Design: one thread per ray, 256 threads a block. The triangles (v0, e1,
// e2: 36 B each) are copied once per block into shared memory, so every
// triangle read in the loop is a broadcast from shared memory. The loop
// visits triangles in index order and accepts a hit only on the strict
// tmin < t < t_best, with the same epsilon as the TPU kernel, so ties go
// to the lowest index exactly as there. A dead ray (tmax <= tmin) skips
// the loop; an any-hit ray leaves it at its first accepted hit. Built
// with --fmad=false: an FMA would change det/u/v by an ulp and flip hits
// on triangle edges against the plain version.
#include <cuda_runtime.h>

#define STATIC_MAX_TRIS 128
#define STATIC_BLOCK 256

__global__ void static_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs,
    float tmin, const float* __restrict__ tmax,
    const float* __restrict__ tris, int n_rays, int n_tris, int any_hit,
    float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ prim_out,
    unsigned char* __restrict__ hit_out) {
  __shared__ float s_tris[STATIC_MAX_TRIS * 9];
  for (int i = threadIdx.x; i < n_tris * 9; i += blockDim.x) s_tris[i] = tris[i];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  const float ox = origins[3 * r], oy = origins[3 * r + 1], oz = origins[3 * r + 2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  float t_best = tmax[r];
  float bu = 0.0f, bv = 0.0f;
  int prim = -1;

  if (t_best > tmin) {
    for (int k = 0; k < n_tris; ++k) {
      const float* tr = s_tris + 9 * k;
      const float v0x = tr[0], v0y = tr[1], v0z = tr[2];
      const float e1x = tr[3], e1y = tr[4], e1z = tr[5];
      const float e2x = tr[6], e2y = tr[7], e2z = tr[8];
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool det_ok = fabsf(det) > 1e-12f;
      const float inv_det = det_ok ? 1.0f / det : 0.0f;
      const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
      const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
      const float qx = tvy * e1z - tvz * e1y;
      const float qy = tvz * e1x - tvx * e1z;
      const float qz = tvx * e1y - tvy * e1x;
      const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool ok = det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f &&
                      tt > tmin && tt < t_best;
      if (ok) {
        t_best = tt;
        bu = uu;
        bv = vv;
        prim = k;
        if (any_hit) break;
      }
    }
  }
  if (any_hit) {
    hit_out[r] = prim >= 0 ? 1 : 0;
  } else {
    t_out[r] = t_best;
    u_out[r] = bu;
    v_out[r] = bv;
    prim_out[r] = prim;
  }
}

extern "C" int static_trace(const float* origins, const float* dirs, float tmin,
                            const float* tmax, const float* tris, int n_rays,
                            int n_tris, int any_hit, float* t_out, float* u_out,
                            float* v_out, int* prim_out, unsigned char* hit_out,
                            int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_tris > STATIC_MAX_TRIS) return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const int grid = (n_rays + STATIC_BLOCK - 1) / STATIC_BLOCK;
    static_trace_kernel<<<grid, STATIC_BLOCK, 0, stream>>>(
        origins, dirs, tmin, tmax, tris, n_rays, n_tris, any_hit, t_out, u_out,
        v_out, prim_out, hit_out);
  }
  return (int)cudaGetLastError();
}
