// K8 brute_trace: closest-hit and any-hit ray queries against every
// triangle of a scene of any size, by brute force.
//
// Replaces capsaicin_tpu/ops/pallas_intersect.py:_closest_kernel and
// _any_kernel (with _mt_tile), which test 512-ray blocks against
// 512-triangle chunks held in VMEM and carry the best hit across the
// chunk axis of the grid.
//
// Bound: the instructions each ray-triangle pair issues. Every live ray
// meets every triangle (an any-hit ray those up to its first hit); memory
// traffic is 28 B in and 16 B out a ray, and the triangles are read once
// a block from L2. The first design ran the whole Moller-Trumbore test with
// the IEEE reciprocal of det on every pair, reading nine scalar floats a
// triangle from shared memory: 1.1-1.6x K1's time on the same rays.
//
// Design: K1's (static_trace.cu) over tiles. One thread a ray, 256 a block.
// - The block stages the triangles BRUTE_TILE at a time in shared memory,
//   three float4s each (v0, e1, e2), the last tile padded to a multiple of
//   MT_STEP with degenerate triangles. Two buffers: the copy of tile i + 1
//   (cp.async, 4 bytes a float, from the [T,9] rows) is in flight while tile
//   i is tested; one barrier a tile both publishes tile i and frees the
//   buffer of tile i - 1 for the next copy. A scene that fits one tile
//   (the Cornell box) has its own instance without the pipeline: staged
//   with plain loads, as K1 stages it, one __syncthreads.
// - A pair is tested in K1's three stages (`mt_test.cuh`: a division-free
//   prefilter, then the plain version's exact test on the pairs it keeps),
//   so the results are bit-equal to brute_trace_plain (its arithmetic is
//   K1's). The best hit, and the prefilter's bound above it, carry across
//   tiles; the strict tmin < t < t_best in index order sends ties to the
//   lowest triangle index across tiles too.
// - A dead ray (tmax <= tmin) tests nothing; an any-hit ray stops at its
//   first hit, and the block stops loading tiles once none of its rays is
//   still live (the barrier is a __syncthreads_or). A miss returns t =
//   1e30, prim = -1, u = v = 0, the contract of the TPU kernel and of the
//   oracle.
// Built with --fmad=false (see mt_test.cuh).
#include <cuda_pipeline.h>

#include "mt_test.cuh"

#define BRUTE_BLOCK 256
#define BRUTE_TILE 256  // triangles a tile: 12,288 B a buffer
#define BRUTE_MISS 1e30f

// The padded length of the tile that starts at triangle `base`.
__device__ __forceinline__ int brute_tile_pad(int base, int n_tris) {
  return (min(BRUTE_TILE, n_tris - base) + MT_STEP - 1) / MT_STEP * MT_STEP;
}

// Starts the copy of the tile at `base` into `tile`, a float of a [T,9] row
// at a time into the x, y, z of its float4, and zeroes the padding; one
// commit group.
__device__ __forceinline__ void brute_stage(float4* tile, const float* __restrict__ tris, int base,
                                            int n_tris) {
  const int count = min(BRUTE_TILE, n_tris - base);
  const float* src = tris + 9 * (size_t)base;
  for (int i = threadIdx.x; i < 9 * count; i += BRUTE_BLOCK)  // float i: vector i / 3
    __pipeline_memcpy_async(reinterpret_cast<float*>(tile + i / 3) + i % 3, src + i, 4);
  for (int i = 3 * count + threadIdx.x; i < 3 * brute_tile_pad(base, n_tris); i += BRUTE_BLOCK)
    tile[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __pipeline_commit();
}

// ONE_TILE: the scene fits one tile (n_tris <= BRUTE_TILE); it is staged
// once with plain loads, as K1 stages its triangles, and the kernel holds
// no pipeline state.
template <bool ANY, bool ONE_TILE>
__global__ void __launch_bounds__(BRUTE_BLOCK) brute_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin, float tmin_lo,
    const float* __restrict__ tmax, const float* __restrict__ tris, int n_rays, int n_tris,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ prim_out, unsigned char* __restrict__ hit_out) {
  __shared__ float4 s_tris[ONE_TILE ? 1 : 2][3 * BRUTE_TILE];
  if (ONE_TILE) {
    const int n_pad = brute_tile_pad(0, n_tris);
    for (int i = threadIdx.x; i < 3 * n_pad; i += BRUTE_BLOCK) {
      const float* row = tris + 3 * i;  // triangle i / 3, vector i % 3
      s_tris[0][i] = i < 3 * n_tris ? make_float4(row[0], row[1], row[2], 0.0f)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
  }
  const int r = blockIdx.x * BRUTE_BLOCK + threadIdx.x;
  const bool in_range = r < n_rays;
  if (ONE_TILE && !in_range) return;
  MtRay ray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float t_best = 0.0f;
  if (in_range) {
    ray = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2],
           dirs[3 * r],    dirs[3 * r + 1],    dirs[3 * r + 2]};
    t_best = tmax[r];
  }
  float bu = 0.0f, bv = 0.0f;
  int prim = -1;
  bool live = in_range && t_best > tmin;
  float t_hi = mt_t_hi(t_best);

  if (ONE_TILE) {
    if (live)
      mt_tile<ANY>(s_tris[0], brute_tile_pad(0, n_tris), 0, ray, tmin, tmin_lo, t_best, t_hi, bu,
                   bv, prim);
  } else {
    const int n_tiles = (n_tris + BRUTE_TILE - 1) / BRUTE_TILE;
    brute_stage(s_tris[0], tris, 0, n_tris);
    for (int i = 0; i < n_tiles; ++i) {
      __pipeline_wait_prior(0);  // this thread's part of tile i has landed
      // every part has, and every thread is done with tile i - 1
      if (!__syncthreads_or(live)) break;
      const int base = i * BRUTE_TILE;
      if (i + 1 < n_tiles) brute_stage(s_tris[(i + 1) & 1], tris, base + BRUTE_TILE, n_tris);
      if (live && mt_tile<ANY>(s_tris[i & 1], brute_tile_pad(base, n_tris), base, ray, tmin,
                               tmin_lo, t_best, t_hi, bu, bv, prim))
        live = false;
    }
  }
  if (!in_range) return;
  if (ANY) {
    hit_out[r] = prim >= 0 ? 1 : 0;
  } else {
    t_out[r] = prim >= 0 ? t_best : BRUTE_MISS;
    u_out[r] = bu;
    v_out[r] = bv;
    prim_out[r] = prim;
  }
}

// The kernel for a query and a scene size.
static const void* brute_kernel(bool any_hit, int n_tris) {
  const bool one = n_tris <= BRUTE_TILE;
  if (any_hit)
    return one ? reinterpret_cast<const void*>(brute_trace_kernel<true, true>)
               : reinterpret_cast<const void*>(brute_trace_kernel<true, false>);
  return one ? reinterpret_cast<const void*>(brute_trace_kernel<false, true>)
             : reinterpret_cast<const void*>(brute_trace_kernel<false, false>);
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
    float lo = mt_tmin_lo(tmin);
    void* args[] = {&origins, &dirs,  &tmin,  &lo,    &tmax,     &tris,   &n_rays,
                    &n_tris,  &t_out, &u_out, &v_out, &prim_out, &hit_out};
    return (int)cudaLaunchKernel(brute_kernel(any_hit, n_tris), grid, BRUTE_BLOCK, args, 0,
                                 stream);
  }
  return (int)cudaGetLastError();
}

// K8's build on `device` for a query and a scene size, as static_trace_info
// gives K1's: registers and local (spilled) bytes a thread, static shared
// bytes a block, 0 dynamic bytes, resident blocks of BRUTE_BLOCK an SM, SMs.
extern "C" int brute_trace_info(int any_hit, int n_tris, int* out, int device) {
  cudaSetDevice(device);
  const void* fn = brute_kernel(any_hit, n_tris);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, BRUTE_BLOCK, 0);
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
