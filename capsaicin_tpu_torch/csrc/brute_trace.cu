// K8 brute_trace: closest-hit and any-hit ray queries against every
// triangle of a scene of any size, by brute force.
//
// Replaces capsaicin_tpu/ops/pallas_intersect.py:_closest_kernel and
// _any_kernel (with _mt_tile), which test 512-ray blocks against
// 512-triangle chunks held in VMEM and carry the best hit across the
// chunk axis of the grid.
//
// Bound: arithmetic. Each ray-triangle pair costs about 45 FLOP of
// Moller-Trumbore and every ray meets every triangle; memory traffic is
// 32 B in and 16 B out per ray, and the triangles are read once per block
// from L2.
//
// Design: one thread per ray, 256 a block. The block stages the
// triangles (v0, e1, e2: 36 B each) through shared memory, 256 at a time,
// and every thread loops over each tile in index order: a triangle read in
// the loop is a broadcast from shared memory. The hit rule is K1's: a hit
// is accepted only on the strict tmin < t < t_best (t_best starts at
// tmax), so ties go to the lowest triangle index, as the oracle's argmin
// gives. A miss returns t = 1e30, the contract of the TPU kernel and of
// the oracle. An any-hit ray stops at its first accepted hit, and the
// block stops loading tiles once none of its rays is still live; a dead
// ray (tmax <= tmin) tests nothing. Built with --fmad=false.
#include <cuda_runtime.h>

#define BRUTE_BLOCK 256
#define BRUTE_TILE 256
#define BRUTE_MISS 1e30f

__global__ void __launch_bounds__(BRUTE_BLOCK) brute_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
    const float* __restrict__ tmax, const float* __restrict__ tris, int n_rays,
    int n_tris, int any_hit, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ prim_out,
    unsigned char* __restrict__ hit_out) {
  __shared__ float s_tris[BRUTE_TILE * 9];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool in_range = r < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float t_best = 0.0f;
  if (in_range) {
    ox = origins[3 * r], oy = origins[3 * r + 1], oz = origins[3 * r + 2];
    dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
    t_best = tmax[r];
  }
  float bu = 0.0f, bv = 0.0f;
  int prim = -1;
  bool live = in_range && t_best > tmin;

  for (int base = 0; base < n_tris; base += BRUTE_TILE) {
    // also the barrier before the tile is overwritten
    if (!__syncthreads_or(live)) break;
    const int count = min(BRUTE_TILE, n_tris - base);
    for (int i = threadIdx.x; i < count * 9; i += blockDim.x) s_tris[i] = tris[9 * base + i];
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      const float* tr = s_tris + 9 * j;
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
      if (det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin && tt < t_best) {
        t_best = tt;
        bu = uu;
        bv = vv;
        prim = base + j;
        if (any_hit) {
          live = false;
          break;
        }
      }
    }
  }
  if (!in_range) return;
  if (any_hit) {
    hit_out[r] = prim >= 0 ? 1 : 0;
  } else {
    t_out[r] = prim >= 0 ? t_best : BRUTE_MISS;
    u_out[r] = bu;
    v_out[r] = bv;
    prim_out[r] = prim;
  }
}

extern "C" int brute_trace(const float* origins, const float* dirs, float tmin,
                           const float* tmax, const float* tris, int n_rays, int n_tris,
                           int any_hit, float* t_out, float* u_out, float* v_out,
                           int* prim_out, unsigned char* hit_out, int device,
                           cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_tris < 0) return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const int grid = (n_rays + BRUTE_BLOCK - 1) / BRUTE_BLOCK;
    brute_trace_kernel<<<grid, BRUTE_BLOCK, 0, stream>>>(
        origins, dirs, tmin, tmax, tris, n_rays, n_tris, any_hit, t_out, u_out, v_out,
        prim_out, hit_out);
  }
  return (int)cudaGetLastError();
}
