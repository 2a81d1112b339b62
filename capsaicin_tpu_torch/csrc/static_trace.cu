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
//   float4s each, padded to a multiple of MT_STEP with degenerate
//   triangles; the loop reads a triangle in three broadcasts and runs
//   MT_STEP triangles a step.
// - A pair is tested in three stages, a division-free prefilter before the
//   plain version's exact test, so the results are bit-equal
//   (`mt_test.cuh`, the test K8 brute_trace runs too).
// Built with --fmad=false (see mt_test.cuh).
#include "mt_test.cuh"

#define STATIC_MAX_TRIS 128
#define STATIC_BLOCK 256

template <bool ANY>
__global__ void __launch_bounds__(STATIC_BLOCK)
static_trace_kernel(const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
                    float tmin_lo, const float* __restrict__ tmax, const float* __restrict__ tris,
                    int n_rays, int n_tris, float* __restrict__ t_out, float* __restrict__ u_out,
                    float* __restrict__ v_out, int* __restrict__ prim_out,
                    unsigned char* __restrict__ hit_out) {
  __shared__ float4 s_tris[3 * STATIC_MAX_TRIS];  // v0, e1, e2 of each triangle
  const int n_pad = (n_tris + MT_STEP - 1) / MT_STEP * MT_STEP;
  for (int i = threadIdx.x; i < 3 * n_pad; i += STATIC_BLOCK) {
    const float* row = tris + 3 * i;  // triangle i / 3, vector i % 3
    s_tris[i] = i < 3 * n_tris ? make_float4(row[0], row[1], row[2], 0.0f)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();

  const int r = blockIdx.x * STATIC_BLOCK + threadIdx.x;
  if (r >= n_rays) return;
  const MtRay ray = {origins[3 * r], origins[3 * r + 1], origins[3 * r + 2],
                     dirs[3 * r],    dirs[3 * r + 1],    dirs[3 * r + 2]};
  float t_best = tmax[r];
  float bu = 0.0f, bv = 0.0f;
  int prim = -1;

  if (t_best > tmin) {
    float t_hi = mt_t_hi(t_best);
    mt_tile<ANY>(s_tris, n_pad, 0, ray, tmin, tmin_lo, t_best, t_hi, bu, bv, prim);
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

extern "C" int static_trace(const float* origins, const float* dirs, float tmin,
                            const float* tmax, const float* tris, int n_rays, int n_tris,
                            int any_hit, float* t_out, float* u_out, float* v_out, int* prim_out,
                            unsigned char* hit_out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_tris > STATIC_MAX_TRIS) return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const int grid = (n_rays + STATIC_BLOCK - 1) / STATIC_BLOCK;
    const float lo = mt_tmin_lo(tmin);
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
