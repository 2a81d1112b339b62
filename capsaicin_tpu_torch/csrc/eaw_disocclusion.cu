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
// and geo (four channels each) and of the moments (3 channels), and
// writes one four-channel pixel.
//
// Design: one thread per pixel in 16x16 blocks over [H,W,C] buffers, taps
// read through the read-only cache (__ldg), so that the block's
// overlapping 22x22 footprint is served from L1/L2 rather than device
// memory. An explicit bounds test and depth >= 1e-5 form the valid mask.
// Two instances: float32 storage, and bf16 storage (eaw_bf16: arithmetic
// in float32, the output rounded to bf16). Built with --fmad=false.
#include "eaw_common.cuh"

template <typename S>
__global__ void eaw_disocclusion_kernel(const S* __restrict__ col,
                                        const S* __restrict__ geo,
                                        const S* __restrict__ mom,
                                        S* __restrict__ out, int height,
                                        int width, float s_normal,
                                        float s_depth, float s_luma) {
  const int x = blockIdx.x * EAW_TILE + threadIdx.x;
  const int y = blockIdx.y * EAW_TILE + threadIdx.y;
  if (x >= width || y >= height) return;
  const int idx = y * width + x;
  const float4 c = eaw_load4(col, idx);
  const float cr = fminf(c.x, EAW_FIREFLY_CLAMP);
  const float cg = fminf(c.y, EAW_FIREFLY_CLAMP);
  const float cb = fminf(c.z, EAW_FIREFLY_CLAMP);
  const float cv = c.w;
  const float4 g = eaw_load4(geo, idx);
  const float hist_len = eaw_load1(mom, 3 * idx + 2);
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
      const float4 tg = eaw_load4(geo, t);
      if (!(tg.w >= 1e-5f)) continue;
      const float4 tc = eaw_load4(col, t);
      const float tr = fminf(tc.x, EAW_FIREFLY_CLAMP);
      const float tgr = fminf(tc.y, EAW_FIREFLY_CLAMP);
      const float tb = fminf(tc.z, EAW_FIREFLY_CLAMP);
      const float w = eaw_edge_weight(g, tg, s_normal, s_d_base * eaw_radius(dx, dy));
      const float lw = expf(-fabsf(cl - eaw_lum(tr, tgr, tb)) / s_luma);
      const float w_full = w * lw;
      acc_r += w_full * tr;
      acc_g += w_full * tgr;
      acc_b += w_full * tb;
      acc_m1 += w_full * eaw_load1(mom, 3 * t);
      acc_m2 += w_full * eaw_load1(mom, 3 * t + 1);
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
  eaw_store4(out, idx, o);
}

template <typename S>
static int launch_eaw_disocclusion(const void* col, const void* geo,
                                   const void* mom, void* out, int height,
                                   int width, float s_normal, float s_depth,
                                   float s_luma, int device,
                                   cudaStream_t stream) {
  cudaSetDevice(device);
  if (height > 0 && width > 0) {
    const dim3 block(EAW_TILE, EAW_TILE);
    const dim3 grid((width + EAW_TILE - 1) / EAW_TILE,
                    (height + EAW_TILE - 1) / EAW_TILE);
    eaw_disocclusion_kernel<S><<<grid, block, 0, stream>>>(
        static_cast<const S*>(col), static_cast<const S*>(geo),
        static_cast<const S*>(mom), static_cast<S*>(out), height, width,
        s_normal, s_depth, s_luma);
  }
  return (int)cudaGetLastError();
}

extern "C" int eaw_disocclusion(const void* col, const void* geo,
                                const void* mom, void* out, int height,
                                int width, float s_normal, float s_depth,
                                float s_luma, int device, cudaStream_t stream) {
  return launch_eaw_disocclusion<float>(col, geo, mom, out, height, width,
                                        s_normal, s_depth, s_luma, device,
                                        stream);
}

extern "C" int eaw_disocclusion_bf16(const void* col, const void* geo,
                                     const void* mom, void* out, int height,
                                     int width, float s_normal, float s_depth,
                                     float s_luma, int device,
                                     cudaStream_t stream) {
  return launch_eaw_disocclusion<__nv_bfloat16>(col, geo, mom, out, height,
                                                width, s_normal, s_depth,
                                                s_luma, device, stream);
}
