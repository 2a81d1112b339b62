// Shared pieces of the edge-aware stencil kernels (K3 eaw_disocclusion,
// K4 eaw_stage, K5 spatial_gather, K6 eaw_pair): the luma, the constants
// of eaw_blur.hlsl and the storage loads and stores. The tap they all
// compute is eaw_tap.cuh's.
//
// Layout: images are [H,W,C] with channels last: color (r, g, b,
// variance) and geo (decoded normal xyz, depth) read as four values per
// pixel, the moments and the gather's indirect light as scalars. Storage
// is float32 or bfloat16 (the eaw_bf16 option); arithmetic is float32
// either way. A bf16 value widens to float32 exactly (its bits shifted up);
// a result is rounded to bf16 to nearest-even, as torch's .to(bfloat16) and
// jnp's astype round. A tap is valid where it lies inside the image and
// its depth is at least 1e-5 (capsaicin_tpu/render/passes.py: in-bounds AND
// d_tap >= 1e-5).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define EAW_EPS 1e-8f
#define EAW_FIREFLY_CLAMP 10.0f
#define EAW_SPATIAL_VARIANCE_THRESHOLD 8.0f

// ---- storage: float or __nv_bfloat16 ------------------------------------

__device__ __forceinline__ float eaw_bf16_lo(unsigned int r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float eaw_bf16_hi(unsigned int r) { return __uint_as_float(r & 0xffff0000u); }
__device__ __forceinline__ unsigned int eaw_bf16_bits(float v) {
  return (unsigned int)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// pixel `idx` of a four-channel image (float: 16-byte loads, bf16: 8-byte)
__device__ __forceinline__ float4 eaw_load4(const float* p, int idx) {
  return __ldg(reinterpret_cast<const float4*>(p) + idx);
}
__device__ __forceinline__ float4 eaw_load4(const __nv_bfloat16* p, int idx) {
  const uint2 r = __ldg(reinterpret_cast<const uint2*>(p) + idx);
  return make_float4(eaw_bf16_lo(r.x), eaw_bf16_hi(r.x), eaw_bf16_lo(r.y), eaw_bf16_hi(r.y));
}
// element `i` of any image
__device__ __forceinline__ float eaw_load1(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ float eaw_load1(const __nv_bfloat16* p, int i) {
  return eaw_bf16_lo((unsigned int)__ldg(reinterpret_cast<const unsigned short*>(p) + i));
}
__device__ __forceinline__ void eaw_store4(float* p, int idx, float4 v) {
  reinterpret_cast<float4*>(p)[idx] = v;
}
__device__ __forceinline__ void eaw_store4(__nv_bfloat16* p, int idx, float4 v) {
  uint2 r;
  r.x = eaw_bf16_bits(v.x) | (eaw_bf16_bits(v.y) << 16);
  r.y = eaw_bf16_bits(v.z) | (eaw_bf16_bits(v.w) << 16);
  reinterpret_cast<uint2*>(p)[idx] = r;
}
__device__ __forceinline__ void eaw_store1(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void eaw_store1(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// ---- weights ------------------------------------------------------------

__device__ __forceinline__ float eaw_lum(float r, float g, float b) {
  return r * 0.299f + g * 0.587f + b * 0.114f;
}
