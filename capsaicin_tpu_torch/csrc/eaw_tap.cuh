// The edge-aware tap of K3 eaw_disocclusion, K4 eaw_stage, K5
// spatial_gather and K6 eaw_pair as the card computes it cheaply, and the
// staging of image pixels into shared memory of K3-K5.
//
// The tap. The reference weight of a tap is
//   pow(max(ndot, 0), s_normal) * exp(-|d0 - d1| / (s_d_base * r))
//     [* hw * exp(-|l0 - l1| / s_l)],
// three transcendentals and two divisions. Here the reciprocals are hoisted
// per pixel (inv_d = log2(e) / s_d_base, inv_l = log2(e) / s_l; 1/r is a
// constant of the unrolled tap) and hw enters as its log2, so the weight is
// one power of two of one summed exponent:
//   w = ex2(s_normal * lg2(ndot) + log2(hw) - |d0 - d1| * inv_d / r
//           - |l0 - l1| * inv_l),
// one lg2.approx and one ex2.approx (the special-function unit), both in
// their flush-to-zero forms: a weight below 2^-126 becomes 0. The edge
// cases of the reference: ndot <= 0 gives lg2(0) = -inf and a weight of 0;
// s_normal == 0 raises ndot to at least 1 first (`nfloor`), so the normal
// factor is 2^0 = 1 even at ndot == 0, as pow(0, 0) = 1; the centre tap
// (r == 0) has no depth term (weight 1), and s_d_base == 0 gives inv_d = 0
// (the reference's s_depth_r == 0 guard).
//
// Validity. A staged pixel outside the image is zero (cp.async's zero
// fill, or a zero written; K6 reads zeros there), so its depth 0 fails
// `depth >= 1e-5` exactly as the plain version's zero padding does. An invalid
// tap adds nothing because its exponent is -inf (and every other value it
// is multiplied by, colour or moment, is finite): where the tap has a luma
// term, its staged luminance is +inf (and inv_l is at least
// EAW_TAP_INV_L_MIN, so |l0 - inf| * inv_l = inf even where s_l is +inf);
// K4 without variance has no luma term and stages -inf in the colour's
// fourth channel, which its tap adds to the exponent. Every other term of
// the exponent is finite or -inf, so -inf never meets +inf.
#pragma once
#include "eaw_common.cuh"

#define EAW_LOG2E 1.4426950408889634f
#define EAW_TAP_INV_L_MIN 1e-30f

__device__ __forceinline__ float eaw_lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float eaw_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1/sqrt(d2) for the squared tap distances of a 7x7 footprint, as float
// constants; d2 is known at compile time in the unrolled loops.
__device__ __forceinline__ float eaw_rinv(int d2) {
  switch (d2) {
    case 1: return 1.0f;
    case 2: return 0.70710678118654752f;
    case 4: return 0.5f;
    case 5: return 0.44721359549995794f;
    case 8: return 0.35355339059327376f;
    case 9: return 0.33333333333333333f;
    case 10: return 0.31622776601683793f;
    case 13: return 0.27735009811261456f;
    case 18: return 0.23570226039551584f;
    default: return 0.0f;
  }
}

// log2 of eaw_blur.hlsl's per-axis weight (1, 2/3, 1/6) at |offset| a
__device__ __forceinline__ float eaw_log2_kw(int a) {
  return a == 0 ? 0.0f : (a == 1 ? -0.58496250072115618f : -2.5849625007211562f);
}

// ---- staging: device memory -> shared memory -----------------------------

// One pixel of a four-channel image as it lands in shared memory: float4
// for float32 storage, four bf16 values (8 bytes) for bfloat16.
template <typename S> struct EawRaw4;
template <> struct EawRaw4<float> { typedef float4 type; };
template <> struct EawRaw4<__nv_bfloat16> { typedef uint2 type; };

// cp.async of pixel `idx` of a four-channel image into `dst`, or zeros
// where `inside` is false (src-size 0: nothing is read). Through L1 (.ca):
// at strides 3 and 5 a stage's sectors are half used, and L1 keeps the other
// half for the neighbouring phase (on an H100, K4 7-8% faster there than
// with .cg).
__device__ __forceinline__ void eaw_stage4_async(float4* dst, const float* src, int idx,
                                                 bool inside) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src + 4 * idx), "r"(inside ? 16 : 0));
}
__device__ __forceinline__ void eaw_stage4_async(uint2* dst, const __nv_bfloat16* src, int idx,
                                                 bool inside) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src + 4 * idx), "r"(inside ? 8 : 0));
}
__device__ __forceinline__ void eaw_stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float4 eaw_widen4(float4 r) { return r; }
__device__ __forceinline__ float4 eaw_widen4(uint2 r) {
  return make_float4(eaw_bf16_lo(r.x), eaw_bf16_hi(r.x), eaw_bf16_lo(r.y), eaw_bf16_hi(r.y));
}

// ---- the tap -------------------------------------------------------------

// Per output pixel: the centre's normal and depth, its luminance, and the
// hoisted reciprocals.
struct EawCentre {
  float nx, ny, nz, d, l, inv_d, inv_l;
};

// The exponent of the tap at offset (dx, dy) (in taps, not pixels) whose
// staged geo is `g` and staged luminance `tl`, without the validity term.
// `LUMA` adds the luma term; `hw_log2` is log2 of the tap's constant
// weight. ndot is summed with fmaf.
template <bool LUMA>
__device__ __forceinline__ float eaw_tap_exponent(const EawCentre& c, float4 g, float tl,
                                                  int dx, int dy, float s_normal, float nfloor,
                                                  float hw_log2) {
  const float ndot = __fmaf_rn(c.nz, g.z, __fmaf_rn(c.ny, g.y, c.nx * g.x));
  float e = __fmaf_rn(s_normal, eaw_lg2(fmaxf(ndot, nfloor)), hw_log2);
  if (dx != 0 || dy != 0)
    e = __fmaf_rn(-fabsf(c.d - g.w), c.inv_d * eaw_rinv(dx * dx + dy * dy), e);
  if (LUMA) e = __fmaf_rn(-fabsf(c.l - tl), c.inv_l, e);
  return e;
}
