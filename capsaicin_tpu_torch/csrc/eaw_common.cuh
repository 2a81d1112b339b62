// Shared pieces of the edge-aware stencil kernels (K3 eaw_disocclusion,
// K4 eaw_stage): the luma, the normal*depth edge-stopping weight of
// eaw_edge_stopping.h and the constants of eaw_blur.hlsl.
//
// Layout: images are [H,W,C] float32 with channels last, read as float4
// per pixel: color (r, g, b, variance), geo (decoded normal xyz, depth).
// A tap is valid where it lies inside the image and its depth is at
// least 1e-5; that explicit test is the valid mask of the reference
// formulation (capsaicin_tpu/render/passes.py: in-bounds AND d_tap >= 1e-5).
#pragma once
#include <cuda_runtime.h>

#define EAW_EPS 1e-8f
#define EAW_FIREFLY_CLAMP 10.0f
#define EAW_SPATIAL_VARIANCE_THRESHOLD 8.0f
#define EAW_TILE 16

__device__ __forceinline__ float eaw_lum(float r, float g, float b) {
  return r * 0.299f + g * 0.587f + b * 0.114f;
}

// pow(max(dot(n0, n1), 0), s_normal) * exp(-|d0 - d1| / s_depth_r), with
// the s_depth_r == 0 guard of the centre tap (eaw_edge_stopping.h:4-13).
// powf and expf are the IEEE-accurate versions, not the intrinsics.
__device__ __forceinline__ float eaw_edge_weight(float4 c, float4 t,
                                                 float s_normal,
                                                 float s_depth_r) {
  const float ndot = fmaxf(c.x * t.x + c.y * t.y + c.z * t.z, 0.0f);
  const float nw = powf(ndot, s_normal);
  const float d = s_depth_r == 0.0f ? 0.0f : fabsf(c.w - t.w) / s_depth_r;
  return nw * expf(-d);
}

// The tap's distance from the centre, as float32 (sqrt of an integer is
// correctly rounded, so it equals the float32 of the exact value).
__device__ __forceinline__ float eaw_radius(int dx, int dy) {
  return sqrtf((float)(dx * dx + dy * dy));
}
