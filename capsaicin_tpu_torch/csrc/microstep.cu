// K9 microstep: the per-step cost of a packet's node walk, without leaf
// work, in five variants of the step body.
//
// Replaces tools/microstep.py:make_kernel.kernel, the TPU microbenchmark
// that split the packet traversal kernel's cost per step
// (capsaicin_tpu/ops/pallas_traverse.py:_traverse_kernel) into its parts.
//
// Bound: a chain of dependent steps, each the issue of 1,024 box tests. The
// walk pointer k of step s+1 depends on step s's packet-wide any() in
// `full`, so a packet's steps cannot overlap, and a packet is one block on
// one SM: 64 packets fill 64 of the 132 SMs. A box test is 6 FADD and 6
// FMUL (the FMA pipe) and 10 FMNMX and 3 FSETP (the ALU pipe, half the
// FMA pipe's rate), as --fmad=false keeps them apart, so an SM issues a
// step's tests in at least 1024 x 13 x 2 / 32 / 4 schedulers = 208 clocks
// (tools/sass_chain.py counts the built loop). The first design took about
// 640 clocks a step: one thread a ray (32 warps), each step's record read
// from device memory through L2/L1 after k was known, then a 1,024-thread
// barrier.
//
// Design: one block of MS_THREADS threads is one 1,024-ray packet, MS_RAYS
// rays a thread (ray t + j * MS_THREADS of thread t): four warps, one a
// scheduler, each with MS_RAYS independent box tests a step to hide the
// float32 latency, and the barrier over 4 warps, not 32.
// - The node table is on chip, as the TPU kernel keeps it in VMEM: the
//   first six floats (the box) of each of its 8,192 8-float records are
//   staged once in dynamic shared memory (196,608 B), and a step reads its
//   record from there.
// - fetch reads the record in three 8-byte broadcasts (every lane reads
//   it); onehot, the TPU's lane-select extraction, reads it in one lane a
//   float (lanes 0-5, one 4-byte read each) and broadcasts each float to
//   the warp with a shuffle (six SHFL).
// - Every variant reads the next step's record (const: its 1.0f) at the
//   top of a step, so the box tests hide the read.
// - reduce and full: the packet-wide any() is one __syncthreads_or of the
//   OR of a thread's MS_RAYS hits. Reduce's next record (k + 1's) is read
//   before the tests. Full's is one of two (a hit goes to 2k, a miss to the
//   DFS successor up + 1, each wrapped below 8 x 512): both successors and
//   their records' places are computed before the tests, and after the
//   any() one select and one read remain on the chain. Reading both
//   records before it and selecting their six floats was slower (six more
//   ALU instructions a step: the ALU pipe is the floor, see below), and
//   testing both boxes would double the tests.
// - The step loop is unrolled by 2 (const: not), so that one step's
//   bookkeeping overlaps the next one's.
// Variants (the TPU's names):
//   0 const  - box test against a constant box (its 1.0f read from a
//              volatile shared word every step, so the test is not hoisted
//              out of the loop)
//   1 fetch  - the box of record (k % 16) of row (k % 512) of the [512,128]
//              node table
//   2 onehot - fetch with the lane-select extraction
//   3 reduce - fetch plus the packet-wide any()
//   4 full   - reduce plus the DFS-successor arithmetic and a conditional
//              increment of the output
// const, fetch and onehot discard the box test, as the TPU kernel does. To
// keep it (and so the read) in the program, a thread counts the steps in
// which one of its rays hit and writes the count to a scratch word (`sink`,
// [P, MS_THREADS]), which nothing reads: an empty asm statement that takes
// the hit does not keep it, since nothing in the PTX uses the register, and
// the first design's three lost their tests so. The output [P,1024] is the
// TPU kernel's out [P,1,8,128]. Built with --fmad=false, so the box test
// rounds as the plain walk's does.
#include <cuda_runtime.h>

#define MS_PACKET 1024
#define MS_RAYS 8  // rays a thread
#define MS_THREADS (MS_PACKET / MS_RAYS)
#define MS_ROWS 512
#define MS_LANES 128
#define MS_RECS 16  // 8-float records a row
#define MS_KEEP 6   // floats of a record the box test reads
#define MS_TABLE_BYTES (MS_ROWS * MS_RECS * MS_KEEP * (int)sizeof(float))

__device__ __forceinline__ bool ms_aabb(const float* b, float ox, float oy, float oz, float ix,
                                        float iy, float iz, float tmin, float t_best) {
  const float tx0 = (b[0] - ox) * ix, tx1 = (b[3] - ox) * ix;
  const float ty0 = (b[1] - oy) * iy, ty1 = (b[4] - oy) * iy;
  const float tz0 = (b[2] - oz) * iz, tz1 = (b[5] - oz) * iz;
  const float t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= tmin && t_near <= t_best;
}

// The record k reads: (k % 16) of row (k % 512).
__device__ __forceinline__ int ms_rec(int k) { return (k % MS_ROWS) * MS_RECS + k % MS_RECS; }

// Record rec's box from the staged table, every lane reading it.
__device__ __forceinline__ void ms_read_rec(const float* s_nodes, int rec, float* b) {
  const float2* p = reinterpret_cast<const float2*>(s_nodes + MS_KEEP * rec);
  const float2 a = p[0], c = p[1], d = p[2];
  b[0] = a.x, b[1] = a.y, b[2] = c.x, b[3] = c.y, b[4] = d.x, b[5] = d.y;
}

// The box of the record k reads.
__device__ __forceinline__ void ms_read(const float* s_nodes, int k, float* b) {
  ms_read_rec(s_nodes, ms_rec(k), b);
}

// The same box as onehot extracts it: lanes 0-5 read a float each, and a
// shuffle broadcasts float c from lane c.
__device__ __forceinline__ void ms_lanes(const float* s_nodes, int k, int lane, float* b) {
  const float x = s_nodes[MS_KEEP * ms_rec(k) + min(lane, MS_KEEP - 1)];
#pragma unroll
  for (int c = 0; c < MS_KEEP; ++c) b[c] = __shfl_sync(0xffffffffu, x, c);
}

// The pointer after k's wrap: back into the table's rows past 8 x 512.
__device__ __forceinline__ int ms_wrap(int k) { return k >= 8 * MS_ROWS ? k % MS_ROWS + 2 : k; }

template <int VARIANT>
__global__ void __launch_bounds__(MS_THREADS) microstep_kernel(
    const float* __restrict__ rays, const float* __restrict__ nodes, int steps,
    float* __restrict__ out, int* __restrict__ sink) {
  extern __shared__ float s_nodes[];
  __shared__ volatile float s_one;
  const int t = threadIdx.x;
  const float* ray = rays + (size_t)blockIdx.x * 8 * MS_PACKET + t;
  float ox[MS_RAYS], oy[MS_RAYS], oz[MS_RAYS], ix[MS_RAYS], iy[MS_RAYS], iz[MS_RAYS];
  float tmin[MS_RAYS], t_best[MS_RAYS];
#pragma unroll
  for (int j = 0; j < MS_RAYS; ++j) {
    const float* r = ray + j * MS_THREADS;
    ox[j] = r[0], oy[j] = r[MS_PACKET], oz[j] = r[2 * MS_PACKET];
    ix[j] = r[3 * MS_PACKET], iy[j] = r[4 * MS_PACKET], iz[j] = r[5 * MS_PACKET];
    tmin[j] = r[6 * MS_PACKET], t_best[j] = r[7 * MS_PACKET];
  }
  if (VARIANT == 0) {
    if (t == 0) s_one = 1.0f;
    __syncthreads();
  } else {  // the boxes of the table's 8,192 records, 24 B each
    for (int i = t; i < MS_ROWS * MS_RECS; i += MS_THREADS) {
      const float4 lo = __ldg(reinterpret_cast<const float4*>(nodes + 8 * i));
      const float2 hi = __ldg(reinterpret_cast<const float2*>(nodes + 8 * i + 4));
      float2* dst = reinterpret_cast<float2*>(s_nodes + MS_KEEP * i);
      dst[0] = make_float2(lo.x, lo.y), dst[1] = make_float2(lo.z, lo.w), dst[2] = hi;
    }
    __syncthreads();
  }
  float ones = 0.0f;
  int k = 2, acc = 0, hits = 0;
  // b: record k's box, read a step ahead (every variant reads the next
  // step's record before its tests, which hide the read)
  float b[MS_KEEP];
  float one = VARIANT == 0 ? s_one : 0.0f;
  if (VARIANT == 2) ms_lanes(s_nodes, k, t & 31, b);
  else if (VARIANT != 0) ms_read(s_nodes, k, b);
#pragma unroll (VARIANT == 0 ? 1 : 2)
  for (int step = 0; step < steps; ++step) {
    if (VARIANT <= 2) {
      float b_next[MS_KEEP];
      float one_next = 0.0f;
      if (VARIANT == 0) one_next = s_one;  // read every step: the test is not hoisted
      else if (VARIANT == 1) ms_read(s_nodes, k + 1, b_next);
      else ms_lanes(s_nodes, k + 1, t & 31, b_next);
      if (VARIANT == 0) {
        b[0] = b[1] = b[2] = -one;
        b[3] = b[4] = b[5] = one;
      }
      bool hit = false;
#pragma unroll
      for (int j = 0; j < MS_RAYS; ++j)
        hit |= ms_aabb(b, ox[j], oy[j], oz[j], ix[j], iy[j], iz[j], tmin[j], t_best[j]);
      hits += hit;
      acc += VARIANT == 0 ? step : k;
      k += 1;
      if (VARIANT == 0) {
        one = one_next;
      } else {
#pragma unroll
        for (int c = 0; c < MS_KEEP; ++c) b[c] = b_next[c];
      }
      continue;
    }
    // reduce, full: b holds record k's box. The next record does not wait
    // for the any(): reduce reads k + 1's before the tests; full computes
    // both successors (and their records' places) before them, and after
    // the any() reads the one it selects.
    int k_hit = k + 1, k_miss = k + 1;
    float b_next[MS_KEEP];
    if (VARIANT == 3) {
      ms_read(s_nodes, k_hit, b_next);
    } else {
      const unsigned kk = (unsigned)k;
      const int up = k >> __popc(((~kk) & (kk + 1u)) - 1u);
      k_hit = ms_wrap(2 * k), k_miss = ms_wrap(up <= 1 ? 1 : up + 1);
    }
    const int rec_hit = ms_rec(k_hit), rec_miss = ms_rec(k_miss);
    bool hit = false;
#pragma unroll
    for (int j = 0; j < MS_RAYS; ++j)
      hit |= ms_aabb(b, ox[j], oy[j], oz[j], ix[j], iy[j], iz[j], tmin[j], t_best[j]);
    const bool any_box = __syncthreads_or(hit);
    acc += any_box ? 1 : 0;
    if (VARIANT == 3) {
      k = k_hit;
#pragma unroll
      for (int c = 0; c < MS_KEEP; ++c) b[c] = b_next[c];
    } else {
      if (any_box && k % 64 == 0) ones += 1.0f;
      k = any_box ? k_hit : k_miss;
      ms_read_rec(s_nodes, any_box ? rec_hit : rec_miss, b);
    }
  }
  float* o = out + (size_t)blockIdx.x * MS_PACKET + t;
#pragma unroll
  for (int j = 0; j < MS_RAYS; ++j) o[j * MS_THREADS] = ones + (float)acc;
  sink[blockIdx.x * MS_THREADS + t] = hits;
}

template <int VARIANT>
static cudaError_t ms_launch(const float* rays, const float* nodes, int n_packets, int steps,
                             float* out, int* sink, cudaStream_t stream) {
  const int smem = VARIANT == 0 ? 0 : MS_TABLE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(microstep_kernel<VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  microstep_kernel<VARIANT><<<n_packets, MS_THREADS, smem, stream>>>(rays, nodes, steps, out,
                                                                      sink);
  return cudaGetLastError();
}

// sink: [n_packets, MS_THREADS] int32 scratch.
extern "C" int microstep(const float* rays, const float* nodes, int n_packets, int steps,
                         int variant, float* out, int* sink, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_packets < 1 || steps < 0) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case 0: return (int)ms_launch<0>(rays, nodes, n_packets, steps, out, sink, stream);
    case 1: return (int)ms_launch<1>(rays, nodes, n_packets, steps, out, sink, stream);
    case 2: return (int)ms_launch<2>(rays, nodes, n_packets, steps, out, sink, stream);
    case 3: return (int)ms_launch<3>(rays, nodes, n_packets, steps, out, sink, stream);
    case 4: return (int)ms_launch<4>(rays, nodes, n_packets, steps, out, sink, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K9's build on `device` for one variant: registers and local (spilled)
// bytes a thread, static shared bytes a block, its dynamic shared bytes,
// resident blocks of MS_THREADS an SM, SMs.
extern "C" int microstep_info(int variant, int* out, int device) {
  cudaSetDevice(device);
  const void* fns[] = {reinterpret_cast<const void*>(microstep_kernel<0>),
                       reinterpret_cast<const void*>(microstep_kernel<1>),
                       reinterpret_cast<const void*>(microstep_kernel<2>),
                       reinterpret_cast<const void*>(microstep_kernel<3>),
                       reinterpret_cast<const void*>(microstep_kernel<4>)};
  if (variant < 0 || variant > 4) return (int)cudaErrorInvalidValue;
  const int smem = variant == 0 ? 0 : MS_TABLE_BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(fns[variant], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fns[variant]);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[variant], MS_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = smem;
  out[4] = blocks;
  out[5] = sms;
  return (int)cudaSuccess;
}
