// K9 microstep: the per-step cost of a packet's node walk, without leaf
// work, in five variants of the step body.
//
// Replaces tools/microstep.py:make_kernel.kernel, the TPU microbenchmark
// that split the packet traversal kernel's cost per step
// (capsaicin_tpu/ops/pallas_traverse.py:_traverse_kernel) into its parts.
//
// Bound: latency. A step is a few dozen operations on one packet and, in
// the variants that reduce, a block-wide barrier; the walk pointer k of
// step s+1 depends on step s, so a packet's steps cannot overlap. The
// card runs many packets (blocks) at once and time per step is the
// measured quantity, not a roofline share.
//
// Design: one block of 1024 threads is one 1024-ray packet, thread t its
// ray t; the walk pointer k is the same in every thread, as on the TPU.
// Variants (the TPU's names):
//   0 const  - box test against a constant box
//   1 fetch  - the 8-float record (k % 16) of row (k % 512) of the
//              [512,128] node table, read from device memory
//   2 onehot - the same record from a shared-memory copy of the table's
//              first six floats per record (196,608 B); it replaces the
//              TPU's lane-select extract
//   3 reduce - fetch plus __syncthreads_or, the packet-wide any()
//   4 full   - reduce plus the DFS-successor arithmetic and a conditional
//              increment of the output
// const, fetch and onehot discard the box test, as the TPU kernel does;
// an empty asm statement keeps it (and so the read) in the program. The
// output [P,1024] is the TPU kernel's out [P,1,8,128]. Built with
// --fmad=false, so the box test rounds as the plain walk's does.
#include <cuda_runtime.h>

#define MS_PACKET 1024
#define MS_ROWS 512
#define MS_LANES 128
#define MS_RECS 16  // 8-float records per row
#define MS_KEEP 6   // floats of a record the box test reads

__device__ __forceinline__ bool ms_aabb(float lx, float ly, float lz, float hx, float hy,
                                        float hz, float ox, float oy, float oz, float ix,
                                        float iy, float iz, float tmin, float t_best) {
  const float tx0 = (lx - ox) * ix, tx1 = (hx - ox) * ix;
  const float ty0 = (ly - oy) * iy, ty1 = (hy - oy) * iy;
  const float tz0 = (lz - oz) * iz, tz1 = (hz - oz) * iz;
  const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= tmin && t_near <= t_best;
}

__device__ __forceinline__ void keep(bool x) { asm volatile("" ::"r"((int)x)); }

template <int VARIANT>
__global__ void __launch_bounds__(MS_PACKET) microstep_kernel(
    const float* __restrict__ rays, const float* __restrict__ nodes, int steps,
    float* __restrict__ out) {
  extern __shared__ float s_nodes[];
  const int t = threadIdx.x;
  const float* ray = rays + (size_t)blockIdx.x * 8 * MS_PACKET + t;
  const float ox = ray[0], oy = ray[MS_PACKET], oz = ray[2 * MS_PACKET];
  const float ix = ray[3 * MS_PACKET], iy = ray[4 * MS_PACKET], iz = ray[5 * MS_PACKET];
  const float tmin = ray[6 * MS_PACKET], t_best = ray[7 * MS_PACKET];
  if (VARIANT == 2) {
    for (int i = t; i < MS_ROWS * MS_RECS; i += MS_PACKET)
      for (int c = 0; c < MS_KEEP; ++c) s_nodes[MS_KEEP * i + c] = nodes[8 * i + c];
    __syncthreads();
  }
  float ones = 0.0f;
  int k = 2, acc = 0;
  for (int step = 0; step < steps; ++step) {
    if (VARIANT == 0) {
      keep(ms_aabb(-1.0f, -1.0f, -1.0f, 1.0f, 1.0f, 1.0f, ox, oy, oz, ix, iy, iz, tmin, t_best));
      acc += step;
      k += 1;
      continue;
    }
    const int rec = (k % MS_ROWS) * MS_RECS + k % MS_RECS;
    float b[MS_KEEP];
    if (VARIANT == 2) {
#pragma unroll
      for (int c = 0; c < MS_KEEP; ++c) b[c] = s_nodes[MS_KEEP * rec + c];
    } else {
      const float4 lo = __ldg(reinterpret_cast<const float4*>(nodes + 8 * rec));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(nodes + 8 * rec + 4));
      b[0] = lo.x, b[1] = lo.y, b[2] = lo.z, b[3] = lo.w, b[4] = hi.x, b[5] = hi.y;
    }
    const bool hit = ms_aabb(b[0], b[1], b[2], b[3], b[4], b[5], ox, oy, oz, ix, iy, iz, tmin,
                             t_best);
    if (VARIANT == 3 || VARIANT == 4) {
      const bool any_box = __syncthreads_or(hit);
      if (VARIANT == 4) {
        if (any_box && k % 64 == 0) ones += 1.0f;
        const unsigned kk = (unsigned)k;
        const int up = k >> __popc(((~kk) & (kk + 1u)) - 1u);
        k = any_box ? 2 * k : (up <= 1 ? 1 : up + 1);
        if (k >= 8 * MS_ROWS) k = k % MS_ROWS + 2;
      } else {
        k += 1;
      }
      acc += any_box ? 1 : 0;
    } else {
      keep(hit);
      acc += k;
      k += 1;
    }
  }
  out[(size_t)blockIdx.x * MS_PACKET + t] = ones + (float)acc;
}

extern "C" int microstep(const float* rays, const float* nodes, int n_packets, int steps,
                         int variant, float* out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_packets < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_packets), block(MS_PACKET);
  switch (variant) {
    case 0: microstep_kernel<0><<<grid, block, 0, stream>>>(rays, nodes, steps, out); break;
    case 1: microstep_kernel<1><<<grid, block, 0, stream>>>(rays, nodes, steps, out); break;
    case 2: {
      const int smem = MS_ROWS * MS_RECS * MS_KEEP * (int)sizeof(float);
      cudaFuncSetAttribute(microstep_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
      microstep_kernel<2><<<grid, block, smem, stream>>>(rays, nodes, steps, out);
      break;
    }
    case 3: microstep_kernel<3><<<grid, block, 0, stream>>>(rays, nodes, steps, out); break;
    case 4: microstep_kernel<4><<<grid, block, 0, stream>>>(rays, nodes, steps, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
