// The cull shared by K10 (stream_trace.cu) and K11 (stream_count.cu): a
// sub-packet of 128 rays, one thread a ray, takes the interval bounds of its
// live rays and slab-tests them against a leaf-block box. The arithmetic is
// that of capsaicin_tpu/ops/stream.py:_sub_packet_bounds and _slab (and of
// their plain versions in ops/stream.py), operation for operation, so the
// entry distance tn of a block is the same float everywhere. min and max
// propagate NaN as jnp.minimum and torch.minimum do (fminf would drop it),
// and every comparison with NaN is false, as in numpy.
#pragma once
#include <cuda_runtime.h>

#define STREAM_LANE 128
#define STREAM_WARPS (STREAM_LANE / 32)
#define STREAM_BIG 1e30f  // the bound of a sub-packet without live rays
#define STREAM_NRED 13    // values of the bounds reduction: 6 minima, 7 maxima

__device__ __forceinline__ float stream_safe_inv(float d) {
  return fabsf(d) < 1e-12f ? (d < 0.0f ? -1e12f : 1e12f) : 1.0f / d;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

struct SubPacketBounds {
  float o_lo[3], o_hi[3], i_lo[3], i_hi[3];
  float tmin_lo, tcap0;
  bool any_live;
};

// One ray of sub-packet sp: rays [128 sp, 128 sp + 128), thread threadIdx.x
// of a 128-thread block.
struct StreamRay {
  float o[3], d[3], inv[3], tmax;
  bool in, live;
};

__device__ __forceinline__ StreamRay load_stream_ray(const float* __restrict__ origins,
                                                     const float* __restrict__ dirs, float tmin,
                                                     const float* __restrict__ tmax, int n_rays,
                                                     int sp) {
  StreamRay r;
  const int i = sp * STREAM_LANE + threadIdx.x;
  r.in = i < n_rays;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = r.in ? origins[3 * i + a] : 0.0f;
    r.d[a] = r.in ? dirs[3 * i + a] : 0.0f;
    r.inv[a] = stream_safe_inv(r.d[a]);
  }
  r.tmax = r.in ? tmax[i] : -1.0f;
  r.live = r.in && r.tmax >= tmin;
  return r;
}

// The bounds over the block's live rays (min or max over 128 lanes, exact
// in any order). `red` is shared scratch of STREAM_WARPS * STREAM_NRED
// floats. Every thread of the block must call it; it synchronises.
__device__ __forceinline__ SubPacketBounds sub_packet_bounds(const StreamRay& r, float tmin,
                                                             float* red) {
  float v[STREAM_NRED];
  for (int a = 0; a < 3; ++a) {
    v[a] = r.live ? r.o[a] : STREAM_BIG;
    v[3 + a] = r.live ? r.inv[a] : STREAM_BIG;
    v[6 + a] = r.live ? r.o[a] : -STREAM_BIG;
    v[9 + a] = r.live ? r.inv[a] : -STREAM_BIG;
  }
  v[12] = r.live ? r.tmax : -STREAM_BIG;
  for (int off = 16; off > 0; off >>= 1) {
    for (int k = 0; k < 6; ++k) v[k] = fminf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
    for (int k = 6; k < STREAM_NRED; ++k)
      v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0)
    for (int k = 0; k < STREAM_NRED; ++k) red[warp * STREAM_NRED + k] = v[k];
  SubPacketBounds b;
  b.any_live = __syncthreads_or(r.live) != 0;
  for (int k = 0; k < STREAM_NRED; ++k) {
    float x = red[k];
    for (int w = 1; w < STREAM_WARPS; ++w)
      x = k < 6 ? fminf(x, red[w * STREAM_NRED + k]) : fmaxf(x, red[w * STREAM_NRED + k]);
    v[k] = x;
  }
  for (int a = 0; a < 3; ++a) {
    b.o_lo[a] = v[a];
    b.i_lo[a] = v[3 + a];
    b.o_hi[a] = v[6 + a];
    b.i_hi[a] = v[9 + a];
  }
  b.tcap0 = v[12];
  b.tmin_lo = b.any_live ? tmin : STREAM_BIG;
  return b;
}

__device__ __forceinline__ void interval_products(float al, float ah, float il, float ih,
                                                  float& lo, float& hi) {
  const float p1 = al * il, p2 = al * ih, p3 = ah * il, p4 = ah * ih;
  lo = nan_min(nan_min(p1, p2), nan_min(p3, p4));
  hi = nan_max(nan_max(p1, p2), nan_max(p3, p4));
}

// The interval slab test of one block box (lo xyz, valid), (hi xyz, 0)
// against the sub-packet's bounds; writes the conservative entry tn.
__device__ __forceinline__ bool box_candidate(const SubPacketBounds& b, float4 lo, float4 hi,
                                              float& tn) {
  const float blo[3] = {lo.x, lo.y, lo.z}, bhi[3] = {hi.x, hi.y, hi.z};
  float tf = 0.0f;
  for (int a = 0; a < 3; ++a) {
    float l0, h0, l1, h1;
    interval_products(blo[a] - b.o_hi[a], blo[a] - b.o_lo[a], b.i_lo[a], b.i_hi[a], l0, h0);
    interval_products(bhi[a] - b.o_hi[a], bhi[a] - b.o_lo[a], b.i_lo[a], b.i_hi[a], l1, h1);
    const float alo = nan_min(l0, l1), ahi = nan_max(h0, h1);
    tn = a == 0 ? alo : nan_max(tn, alo);
    tf = a == 0 ? ahi : nan_min(tf, ahi);
  }
  return tn <= tf && tf >= b.tmin_lo && tn <= b.tcap0 && lo.w > 0.0f && b.any_live;
}
