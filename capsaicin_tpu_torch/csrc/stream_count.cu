// K11 stream_count: the candidate-count pass of the stream traversal. Each
// 128-ray sub-packet counts the leaf-block boxes its interval bounds hit;
// the count orders the sub-packets for K10 (ops/stream.balance_order).
//
// Replaces capsaicin_tpu/ops/stream.py:_count_kernel, which culls 8
// sub-packets (a gang of sublanes) against the whole box table held in
// VMEM and writes the count broadcast over 128 lanes.
//
// Bound: the instructions of the box test. The first design (one block a
// sub-packet, every box read through the read-only cache and tested with
// stream_common.cuh's box_candidate) spent a third of its time on the
// test's NaN-propagating min and max (five instructions each; with one
// min.NaN.f32 each: 1.57x faster on an H100, the same counts), while the
// box reads cost nothing beyond the test: the table (256 KB at 8,192
// boxes) stays in L1 and L2.
//
// Design:
// - A block of 128 threads takes K11_GROUP sub-packets. Each warp reduces
//   the bounds of whole sub-packets (each lane four rays; the values of
//   the plain version's _bounds: the origins, stream_safe_inv of the
//   directions, tmax; min and max are exact in any order, and, as in the
//   first design, drop a NaN) into shared memory. Then each thread reads
//   K11_BOXES boxes 128 apart at once and tests them against every live
//   sub-packet of the group, whose bounds the warp reads from shared memory
//   into uniform registers: one read of a box serves the group, one read
//   of a sub-packet's bounds K11_BOXES boxes a lane. A sub-packet without a
//   live ray costs only its bounds.
// - The box test gives the plain version's answer with less work. For a
//   box whose faces are ordered (lo <= hi on each axis, as every box the
//   stream build makes), the products of the slab's two face intervals
//   with the inverse-direction interval reach their minimum and maximum at
//   the corners of [a, b] = [lo - o_hi, hi - o_lo] x [i_lo, i_hi] (a
//   product is monotone in each factor, and rounding keeps the order), and
//   the signs of [i_lo, i_hi], known per sub-packet, name the two corners
//   that hold the minimum and the two that hold the maximum: an axis costs
//   2 subtractions, 4 products, one min and one max (the plain version's:
//   4, 8 and 14), with the same tn and tf. Where every axis straddles 0
//   (i_lo < 0 < i_hi, incoherent rays) and tcap0 >= 0, each axis's minimum
//   is <= 0 and its maximum >= 0, so tn <= 0 <= tf and tn <= tcap0 hold
//   and only tf >= tmin_lo is left: 2 products and a max an axis. Where
//   every ray has the same direction (i_lo == i_hi on every axis, as the
//   shadow rays of the directional light), each extreme is one product,
//   chosen by the sign. The sub-packet's case selects one of 36 instances
//   of the test, a branch every lane of a warp takes. Min and max are
//   min.NaN.f32 / max.NaN.f32, one instruction each, NaN-propagating as
//   jnp.minimum and torch.minimum are. A valid box whose faces are not
//   ordered takes box_candidate itself, and adds its hits in shared memory.
// - Lane s of each warp counts sub-packet s: the warp ballots its boxes'
//   hits on a sub-packet and lane s adds their number, so no thread keeps
//   a count for each sub-packet. The warps' counts are added in shared
//   memory at the end. The grid is one block a group (ops/stream.count_plan).
#include "stream_common.cuh"

#define K11_GROUP 8  // sub-packets a block (at most 32: lane s of a warp counts sub-packet s)
#define K11_BOXES 4  // boxes a thread tests at once, 128 apart
#define K11_MIN_BLOCKS 8  // resident blocks an SM: at most 64 registers a thread
#define K11_STRADDLE 27  // the case code where every axis straddles 0 and tcap0 >= 0
#define K11_POINT 28  // the case codes 28 + sx + 2 sy + 4 sz: i_lo == i_hi on every axis

__device__ __forceinline__ float k11_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float k11_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// The product interval of [a, b] x [il, ih] (a <= b, il <= ih) from the two
// corners that hold its extremes, by the sign case C of [il, ih]: 0 where
// il >= 0 (x * i rises with x: the minimum at a, the maximum at b), 1 where
// ih <= 0 (falls with x), 2 where il < 0 < ih (and where il or ih is NaN:
// every product then holds it).
template <int C>
__device__ __forceinline__ void k11_product(float a, float b, float il, float ih, float& lo,
                                            float& hi) {
  if (C == 0) {
    lo = k11_min(a * il, a * ih);
    hi = k11_max(b * il, b * ih);
  } else if (C == 1) {
    lo = k11_min(b * il, b * ih);
    hi = k11_max(a * il, a * ih);
  } else {
    lo = k11_min(b * il, a * ih);
    hi = k11_max(a * il, b * ih);
  }
}

// [a, b] x [i, i]: one product for each extreme, by the sign of i (S = 1
// where i < 0).
template <int S>
__device__ __forceinline__ void k11_point(float a, float b, float i, float& lo, float& hi) {
  lo = (S ? b : a) * i;
  hi = (S ? a : b) * i;
}

// The interval slab test of an ordered box (lo xyz, valid), (hi xyz, 0)
// against a live sub-packet's bounds, held as four float4s: (o_lo xyz,
// tmin_lo), (o_hi xyz, tcap0), (i_lo xyz, live), (i_hi xyz, case code).
// CODE = cx + 3 cy + 9 cz, K11_STRADDLE, or K11_POINT + sx + 2 sy + 4 sz.
template <int CODE>
__device__ __forceinline__ bool k11_candidate(float4 lo, float4 hi, float4 ol, float4 oh,
                                              float4 il, float4 ih) {
  if (CODE >= K11_POINT) {  // every ray of the sub-packet has the same direction
    float tn, tf, l, h;
    k11_point<(CODE - K11_POINT) & 1>(lo.x - oh.x, hi.x - ol.x, il.x, tn, tf);
    k11_point<((CODE - K11_POINT) >> 1) & 1>(lo.y - oh.y, hi.y - ol.y, il.y, l, h);
    tn = k11_max(tn, l);
    tf = k11_min(tf, h);
    k11_point<((CODE - K11_POINT) >> 2) & 1>(lo.z - oh.z, hi.z - ol.z, il.z, l, h);
    tn = k11_max(tn, l);
    tf = k11_min(tf, h);
    return tn <= tf && tf >= ol.w && tn <= oh.w;
  }
  if (CODE == K11_STRADDLE) {  // tn <= 0 <= tf and tn <= tcap0: tf >= tmin_lo decides
    const float tf = k11_min(k11_min(k11_max((lo.x - oh.x) * il.x, (hi.x - ol.x) * ih.x),
                                     k11_max((lo.y - oh.y) * il.y, (hi.y - ol.y) * ih.y)),
                             k11_max((lo.z - oh.z) * il.z, (hi.z - ol.z) * ih.z));
    return tf >= ol.w;
  }
  float tn, tf, l, h;
  k11_product<CODE % 3>(lo.x - oh.x, hi.x - ol.x, il.x, ih.x, tn, tf);
  k11_product<CODE / 3 % 3>(lo.y - oh.y, hi.y - ol.y, il.y, ih.y, l, h);
  tn = k11_max(tn, l);
  tf = k11_min(tf, h);
  k11_product<CODE / 9>(lo.z - oh.z, hi.z - ol.z, il.z, ih.z, l, h);
  tn = k11_max(tn, l);
  tf = k11_min(tf, h);
  return tn <= tf && tf >= ol.w && tn <= oh.w;
}

__device__ __forceinline__ int k11_case(float il, float ih) {
  return il >= 0.0f ? 0 : (ih <= 0.0f ? 1 : 2);
}

// The hits of the warp's fast boxes (K11_BOXES a lane) on one sub-packet.
template <int CODE>
__device__ __forceinline__ int k11_warp_hits(const float4 (&lo)[K11_BOXES],
                                             const float4 (&hi)[K11_BOXES],
                                             const bool (&fast)[K11_BOXES],
                                             const float4 (&b)[4]) {
  bool hit[K11_BOXES];
#pragma unroll
  for (int j = 0; j < K11_BOXES; ++j)  // every box tested, no branch: the tests interleave
    hit[j] = k11_candidate<CODE>(lo[j], hi[j], b[0], b[1], b[2], b[3]) & fast[j];
  int n = 0;
#pragma unroll
  for (int j = 0; j < K11_BOXES; ++j) n += __popc(__ballot_sync(0xffffffffu, hit[j]));
  return n;
}

// A valid box whose faces are not ordered (no stream build makes one): the
// plain version's test against each live sub-packet of the group, its hits
// added in shared memory.
__device__ __noinline__ void k11_unordered(float4 lo, float4 hi, const float4 (*bounds)[4],
                                           unsigned live, int* s_count) {
  for (int s = 0; s < K11_GROUP; ++s) {
    if (!((live >> s) & 1u)) continue;
    SubPacketBounds b;
    const float4 ol = bounds[s][0], oh = bounds[s][1], il = bounds[s][2], ih = bounds[s][3];
    b.o_lo[0] = ol.x; b.o_lo[1] = ol.y; b.o_lo[2] = ol.z;
    b.o_hi[0] = oh.x; b.o_hi[1] = oh.y; b.o_hi[2] = oh.z;
    b.i_lo[0] = il.x; b.i_lo[1] = il.y; b.i_lo[2] = il.z;
    b.i_hi[0] = ih.x; b.i_hi[1] = ih.y; b.i_hi[2] = ih.z;
    b.tmin_lo = ol.w;
    b.tcap0 = oh.w;
    b.any_live = true;
    float tn;
    if (box_candidate(b, lo, hi, tn)) atomicAdd(&s_count[s], 1);
  }
}

// Sub-packet sp's bounds, by one warp (lane l: rays 128 sp + l + 32 m),
// written by lane 0 with the case code.
__device__ __forceinline__ void k11_bounds(const float* __restrict__ origins,
                                           const float* __restrict__ dirs, float tmin,
                                           const float* __restrict__ tmax, int n_rays, int sp,
                                           float4 (&out)[4], int lane) {
  float v[STREAM_NRED];  // 6 minima (o, inv), 7 maxima (o, inv, tmax)
#pragma unroll
  for (int k = 0; k < STREAM_NRED; ++k) v[k] = k < 6 ? STREAM_BIG : -STREAM_BIG;
  bool any = false;
#pragma unroll
  for (int m = 0; m < STREAM_LANE / 32; ++m) {
    const int i = sp * STREAM_LANE + lane + 32 * m;
    const bool in = i < n_rays;
    const float tm = in ? tmax[i] : -1.0f;
    const bool live = in && tm >= tmin;
    any |= live;
    if (!live) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float o = origins[3 * i + a], inv = stream_safe_inv(dirs[3 * i + a]);
      v[a] = fminf(v[a], o);
      v[3 + a] = fminf(v[3 + a], inv);
      v[6 + a] = fmaxf(v[6 + a], o);
      v[9 + a] = fmaxf(v[9 + a], inv);
    }
    v[12] = fmaxf(v[12], tm);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
#pragma unroll
    for (int k = 6; k < STREAM_NRED; ++k)
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  const bool any_live = __any_sync(0xffffffffu, any);
  if (lane == 0) {
    int code = k11_case(v[3], v[9]) + 3 * k11_case(v[4], v[10]) + 9 * k11_case(v[5], v[11]);
    if (code == 26 && v[12] >= 0.0f) code = K11_STRADDLE;
    if (v[3] == v[9] && v[4] == v[10] && v[5] == v[11])
      code = K11_POINT + (v[3] < 0.0f) + 2 * (v[4] < 0.0f) + 4 * (v[5] < 0.0f);
    out[0] = make_float4(v[0], v[1], v[2], any_live ? tmin : STREAM_BIG);
    out[1] = make_float4(v[6], v[7], v[8], v[12]);
    out[2] = make_float4(v[3], v[4], v[5], any_live ? 1.0f : 0.0f);
    out[3] = make_float4(v[9], v[10], v[11], (float)code);
  }
}

#define K11_CASE(c) \
  case c:           \
    n = k11_warp_hits<c>(lo, hi, fast, b); \
    break;

__global__ void __launch_bounds__(STREAM_LANE, K11_MIN_BLOCKS) stream_count_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
    const float* __restrict__ tmax, const float4* __restrict__ boxes, int n_rays, int n_blocks,
    int n_sub, int* __restrict__ count_out) {
  __shared__ float4 s_bounds[K11_GROUP][4];
  __shared__ int s_count[K11_GROUP];
  const int g0 = blockIdx.x * K11_GROUP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the group's bounds, a sub-packet a warp; a sub-packet past the last is dead
  for (int s = warp; s < K11_GROUP; s += STREAM_WARPS)
    k11_bounds(origins, dirs, tmin, tmax, n_rays, g0 + s, s_bounds[s], lane);
  if (threadIdx.x < K11_GROUP) s_count[threadIdx.x] = 0;
  __syncthreads();
  unsigned live = 0;
#pragma unroll
  for (int s = 0; s < K11_GROUP; ++s) live |= (s_bounds[s][2].w != 0.0f ? 1u : 0u) << s;

  // lane s of each warp counts sub-packet s
  int count = 0;
  if (live) {
    for (int k0 = 0; k0 < n_blocks; k0 += STREAM_LANE * K11_BOXES) {  // the same trips in every warp
      float4 lo[K11_BOXES], hi[K11_BOXES];
      bool fast[K11_BOXES];
#pragma unroll
      for (int j = 0; j < K11_BOXES; ++j) {
        const int k = k0 + j * STREAM_LANE + threadIdx.x;
        const bool here = k < n_blocks;
        lo[j] = here ? __ldg(boxes + 2 * k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        hi[j] = here ? __ldg(boxes + 2 * k + 1) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        // an empty block (valid flag 0) is no candidate
        const bool ordered = lo[j].x <= hi[j].x && lo[j].y <= hi[j].y && lo[j].z <= hi[j].z;
        fast[j] = lo[j].w > 0.0f && ordered;
        if (lo[j].w > 0.0f && !ordered) k11_unordered(lo[j], hi[j], s_bounds, live, s_count);
      }
      for (int s = 0; s < K11_GROUP; ++s) {
        if (!((live >> s) & 1u)) continue;
        const float4 b[4] = {s_bounds[s][0], s_bounds[s][1], s_bounds[s][2], s_bounds[s][3]};
        int n = 0;
        switch ((int)b[3].w) {  // the same in every lane: a warp-uniform branch
          K11_CASE(0) K11_CASE(1) K11_CASE(2) K11_CASE(3) K11_CASE(4) K11_CASE(5)
          K11_CASE(6) K11_CASE(7) K11_CASE(8) K11_CASE(9) K11_CASE(10) K11_CASE(11)
          K11_CASE(12) K11_CASE(13) K11_CASE(14) K11_CASE(15) K11_CASE(16) K11_CASE(17)
          K11_CASE(18) K11_CASE(19) K11_CASE(20) K11_CASE(21) K11_CASE(22) K11_CASE(23)
          K11_CASE(24) K11_CASE(25) K11_CASE(26) K11_CASE(27) K11_CASE(28) K11_CASE(29)
          K11_CASE(30) K11_CASE(31) K11_CASE(32) K11_CASE(33) K11_CASE(34) K11_CASE(35)
        }
        count += lane == s ? n : 0;
      }
    }
  }
  if (lane < K11_GROUP && count) atomicAdd(&s_count[lane], count);
  __syncthreads();
  if (threadIdx.x < K11_GROUP && g0 + threadIdx.x < n_sub)
    count_out[g0 + threadIdx.x] = s_count[threadIdx.x];
}

// One launch of the plan ops/stream.count_plan gives: `grid` blocks of
// STREAM_LANE threads, each K11_GROUP sub-packets of the ceil(n_rays / 128).
extern "C" int stream_count(const float* origins, const float* dirs, float tmin,
                            const float* tmax, const float* boxes, int n_rays, int n_blocks,
                            int grid, int* count_out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_blocks < 1) return (int)cudaErrorInvalidValue;
  if (grid > 0) {
    const int n_sub = (n_rays + STREAM_LANE - 1) / STREAM_LANE;
    stream_count_kernel<<<grid, STREAM_LANE, 0, stream>>>(
        origins, dirs, tmin, tmax, reinterpret_cast<const float4*>(boxes), n_rays, n_blocks,
        n_sub, count_out);
  }
  return (int)cudaGetLastError();
}

// K11's build on `device`: out[0] registers a thread, [1] local bytes a
// thread, [2] static shared bytes a block, [3] resident blocks of
// STREAM_LANE threads an SM, [4] the SMs.
extern "C" int stream_count_info(int* out, int device) {
  cudaSetDevice(device);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, stream_count_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, stream_count_kernel, STREAM_LANE, 0);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = blocks;
  out[4] = sms;
  return (int)cudaSuccess;
}
