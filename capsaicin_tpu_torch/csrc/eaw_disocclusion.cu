// K3 eaw_disocclusion: the first stage of the EAW denoise chain
// (eaw_blur.hlsl BlurDisocclusion): a 7x7 edge-aware blur with a firefly
// clamp at 10 that, where the temporal history is shorter than 8 frames,
// replaces the variance by one estimated from the blurred spatial moments.
//
// Replaces capsaicin_tpu/ops/pallas_stencil.py:_disocc_kernel, which
// reads three planar row windows (color, geo, moments) into VMEM and
// builds its 49 taps from lane rolls.
//
// Bound: L2 and memory traffic. Each output pixel reads 49 taps of color
// and geo (float4 each) and of the moments (3 floats), and writes one
// float4.
//
// Design: one thread per pixel in 16x16 blocks over [H,W,C] buffers, taps
// read through the read-only cache (__ldg), so that the block's
// overlapping 22x22 footprint is served from L1/L2 rather than device
// memory. An explicit bounds test and depth >= 1e-5 form the valid mask.
// Built with --fmad=false.
#include "eaw_common.cuh"

__global__ void eaw_disocclusion_kernel(const float4* __restrict__ col,
                                        const float4* __restrict__ geo,
                                        const float* __restrict__ mom,
                                        float4* __restrict__ out, int height,
                                        int width, float s_normal,
                                        float s_depth, float s_luma) {
  const int x = blockIdx.x * EAW_TILE + threadIdx.x;
  const int y = blockIdx.y * EAW_TILE + threadIdx.y;
  if (x >= width || y >= height) return;
  const int idx = y * width + x;
  const float4 c = col[idx];
  const float cr = fminf(c.x, EAW_FIREFLY_CLAMP);
  const float cg = fminf(c.y, EAW_FIREFLY_CLAMP);
  const float cb = fminf(c.z, EAW_FIREFLY_CLAMP);
  const float cv = c.w;
  const float4 g = geo[idx];
  const float hist_len = mom[3 * idx + 2];
  const float cl = eaw_lum(cr, cg, cb);
  const float s_d_base = g.w * s_depth;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float acc_m1 = 0.0f, acc_m2 = 0.0f, tw = 0.0f;
#pragma unroll
  for (int dy = -3; dy <= 3; ++dy) {
    const int ty = y + dy;
#pragma unroll
    for (int dx = -3; dx <= 3; ++dx) {
      const int tx = x + dx;
      if (ty < 0 || ty >= height || tx < 0 || tx >= width) continue;
      const int t = ty * width + tx;
      const float4 tg = __ldg(&geo[t]);
      if (!(tg.w >= 1e-5f)) continue;
      const float4 tc = __ldg(&col[t]);
      const float tr = fminf(tc.x, EAW_FIREFLY_CLAMP);
      const float tgr = fminf(tc.y, EAW_FIREFLY_CLAMP);
      const float tb = fminf(tc.z, EAW_FIREFLY_CLAMP);
      const float w = eaw_edge_weight(g, tg, s_normal, s_d_base * eaw_radius(dx, dy));
      const float lw = expf(-fabsf(cl - eaw_lum(tr, tgr, tb)) / s_luma);
      const float w_full = w * lw;
      acc_r += w_full * tr;
      acc_g += w_full * tgr;
      acc_b += w_full * tb;
      acc_m1 += w_full * __ldg(&mom[3 * t]);
      acc_m2 += w_full * __ldg(&mom[3 * t + 1]);
      tw += w_full;
    }
  }

  float4 o;
  if (g.w < 1e-5f || hist_len >= EAW_SPATIAL_VARIANCE_THRESHOLD) {
    o = make_float4(cr, cg, cb, cv);
  } else {
    const bool low = tw < EAW_EPS;
    const float inv = 1.0f / fmaxf(tw, EAW_EPS);
    const float f_m1 = low ? 0.0f : acc_m1 * inv;
    const float f_m2 = low ? 0.0f : acc_m2 * inv;
    const float boost = EAW_SPATIAL_VARIANCE_THRESHOLD / fmaxf(hist_len, 1e-5f);
    const float f_v = boost * fabsf(f_m2 - f_m1 * f_m1);
    if (low) {
      o = make_float4(cr, cg, cb, f_v);
    } else {
      o = make_float4(acc_r * inv, acc_g * inv, acc_b * inv, f_v);
    }
  }
  out[idx] = o;
}

extern "C" int eaw_disocclusion(const float* col, const float* geo,
                                const float* mom, float* out, int height,
                                int width, float s_normal, float s_depth,
                                float s_luma, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (height > 0 && width > 0) {
    const dim3 block(EAW_TILE, EAW_TILE);
    const dim3 grid((width + EAW_TILE - 1) / EAW_TILE,
                    (height + EAW_TILE - 1) / EAW_TILE);
    eaw_disocclusion_kernel<<<grid, block, 0, stream>>>(
        reinterpret_cast<const float4*>(col), reinterpret_cast<const float4*>(geo),
        mom, reinterpret_cast<float4*>(out), height, width, s_normal, s_depth,
        s_luma);
  }
  return (int)cudaGetLastError();
}
