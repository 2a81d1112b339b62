// K11 stream_count: the candidate-count pass of the stream traversal. Each
// 128-ray sub-packet counts the leaf-block boxes its interval bounds hit;
// the count orders the sub-packets for K10 (ops/stream.balance_order).
//
// Replaces capsaicin_tpu/ops/stream.py:_count_kernel, which culls 8
// sub-packets (a gang of sublanes) against the whole box table held in
// VMEM and writes the count broadcast over 128 lanes. Here one block of 128
// threads is one sub-packet, and it writes one int32.
//
// Bound: operations. Each sub-packet tests every box (86 float
// operations: 12 subtractions, 24 products, 46 min/max, 4 compares), and
// reads the 32-byte box from L2 (the table, 256 KB at 8192 blocks, stays
// there); the rays are 28 bytes each, read once.
//
// Design: the bounds are warp-shuffle and shared-memory reductions
// (stream_common.cuh); the threads stride over the boxes, two float4 loads
// a box through the read-only cache, and a warp sum then a shared sum count
// the hits.
#include "stream_common.cuh"

__global__ void __launch_bounds__(STREAM_LANE) stream_count_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
    const float* __restrict__ tmax, const float4* __restrict__ boxes, int n_rays, int n_blocks,
    int* __restrict__ count_out) {
  __shared__ float red[STREAM_WARPS * STREAM_NRED];
  __shared__ int total;
  const StreamRay r = load_stream_ray(origins, dirs, tmin, tmax, n_rays, blockIdx.x);
  if (threadIdx.x == 0) total = 0;
  const SubPacketBounds b = sub_packet_bounds(r, tmin, red);  // synchronises
  int count = 0;
  if (b.any_live) {
    for (int k = threadIdx.x; k < n_blocks; k += STREAM_LANE) {
      float tn;
      count += box_candidate(b, __ldg(boxes + 2 * k), __ldg(boxes + 2 * k + 1), tn) ? 1 : 0;
    }
  }
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0) atomicAdd(&total, count);
  __syncthreads();
  if (threadIdx.x == 0) count_out[blockIdx.x] = total;
}

extern "C" int stream_count(const float* origins, const float* dirs, float tmin,
                            const float* tmax, const float* boxes, int n_rays, int n_blocks,
                            int* count_out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const int grid = (n_rays + STREAM_LANE - 1) / STREAM_LANE;
    stream_count_kernel<<<grid, STREAM_LANE, 0, stream>>>(
        origins, dirs, tmin, tmax, reinterpret_cast<const float4*>(boxes), n_rays, n_blocks,
        count_out);
  }
  return (int)cudaGetLastError();
}
