// Shared pieces of the edge-aware stencil kernels (K3 eaw_disocclusion,
// K4 eaw_stage, K5 spatial_gather, K6 eaw_pair): the luma, the constants
// of eaw_blur.hlsl and the storage loads and stores; and, for K6 alone, the
// IEEE normal*depth edge-stopping weight of eaw_edge_stopping.h and the
// body of one a-trous stage (K3-K5 take the tap of eaw_tap.cuh).
//
// Layout: images are [H,W,C] with channels last: color (r, g, b,
// variance) and geo (decoded normal xyz, depth) read as four values per
// pixel, the moments and the gather's indirect light as scalars. Storage
// is float32 or bfloat16 (the eaw_bf16 option); arithmetic is float32
// either way. A bf16 value widens to float32 exactly (its bits shifted up);
// a result is rounded to bf16 to nearest-even, as torch's .to(bfloat16) and
// jnp's astype round. A tap is valid where it lies inside the image and
// its depth is at least 1e-5; K6's explicit test is the valid mask of the
// reference formulation (capsaicin_tpu/render/passes.py: in-bounds AND
// d_tap >= 1e-5).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define EAW_EPS 1e-8f
#define EAW_FIREFLY_CLAMP 10.0f
#define EAW_SPATIAL_VARIANCE_THRESHOLD 8.0f
#define EAW_TILE 16  // K6's tile

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

__device__ __forceinline__ double eaw_kw(int a) {
  return a == 0 ? 1.0 : (a == 1 ? 2.0 / 3.0 : 1.0 / 6.0);
}

// ---- one a-trous stage (eaw_blur.hlsl Blur) ------------------------------

// Color taps of a stage read from an image in device memory.
template <typename S>
struct EawGlobalColor {
  const S* p;
  int width;
  __device__ __forceinline__ float4 operator()(int x, int y) const {
    return eaw_load4(p, y * width + x);
  }
};

// One Blur stage at pixel (x, y): 5x5 taps at `stride`, weights (1, 2/3,
// 1/6) per axis, normal and depth edge stopping, a luma sigma scaled by
// the variance, the variance filtered with the squared weights. Color taps
// (unclamped; the stage clamps rgb on read) come from `color_at(x, y)`,
// geo from the geo image. Taps are summed in the order of the reference
// (dy outer, dx inner); an invalid tap is skipped before its color is read.
template <typename G, typename ColorAt>
__device__ __forceinline__ float4 eaw_stage_pixel(const ColorAt& color_at,
                                                  const G* geo, int x, int y,
                                                  int height, int width,
                                                  int stride, int use_variance,
                                                  float s_normal, float s_depth,
                                                  float s_luma) {
  const float4 c = color_at(x, y);
  const float cr = fminf(c.x, EAW_FIREFLY_CLAMP);
  const float cg = fminf(c.y, EAW_FIREFLY_CLAMP);
  const float cb = fminf(c.z, EAW_FIREFLY_CLAMP);
  const float cv = c.w;
  const float4 g = eaw_load4(geo, y * width + x);
  const float cl = eaw_lum(cr, cg, cb);
  const float s_l_eff = s_luma * sqrtf(fmaxf(0.0f, cv + EAW_EPS));
  const float s_d_base = g.w * (float)stride * s_depth;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_v = 0.0f, tw = 0.0f;
#pragma unroll
  for (int dy = -2; dy <= 2; ++dy) {
    const int ty = y + dy * stride;
#pragma unroll
    for (int dx = -2; dx <= 2; ++dx) {
      const int tx = x + dx * stride;
      if (ty < 0 || ty >= height || tx < 0 || tx >= width) continue;
      const float4 tg = eaw_load4(geo, ty * width + tx);
      if (!(tg.w >= 1e-5f)) continue;
      const float4 tc = color_at(tx, ty);
      const float tr = fminf(tc.x, EAW_FIREFLY_CLAMP);
      const float tgr = fminf(tc.y, EAW_FIREFLY_CLAMP);
      const float tb = fminf(tc.z, EAW_FIREFLY_CLAMP);
      const float w = eaw_edge_weight(g, tg, s_normal, s_d_base * eaw_radius(dx, dy));
      float w_full;
      if (use_variance) {
        const float lw = expf(-fabsf(cl - eaw_lum(tr, tgr, tb)) / s_l_eff);
        const float hw = (float)(eaw_kw(dx < 0 ? -dx : dx) * eaw_kw(dy < 0 ? -dy : dy));
        w_full = w * hw * lw;
        const float hw_w = hw * w;
        acc_v += hw_w * hw_w * lw * lw * tc.w;
      } else {
        w_full = w;
      }
      acc_r += w_full * tr;
      acc_g += w_full * tgr;
      acc_b += w_full * tb;
      tw += w_full;
    }
  }

  if (g.w < 1e-5f || tw < EAW_EPS) return make_float4(cr, cg, cb, cv);
  const float inv = 1.0f / fmaxf(tw, EAW_EPS);
  return make_float4(acc_r * inv, acc_g * inv, acc_b * inv,
                     use_variance ? acc_v * inv * inv : acc_v);
}
