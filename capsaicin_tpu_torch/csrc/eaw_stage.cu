// K4 eaw_stage: one 5x5 a-trous stage of the EAW denoise chain
// (eaw_blur.hlsl Blur): weights (1, 2/3, 1/6) per axis, normal and depth
// edge stopping, a luma sigma scaled by the variance, and the variance
// filtered with the squared weights.
//
// Replaces capsaicin_tpu/ops/pallas_stencil.py:_eaw_kernel (its body is
// _eaw_stage), which reads row tiles of a column-padded planar layout into
// VMEM and builds the taps from lane rolls.
//
// Bound: L2 and memory traffic. Each output pixel reads 25 taps of two
// float4 (color, geo) and writes one float4; the chain runs it at strides
// 1, 3, 5 and 7, so at wide strides neighbouring threads' taps share no
// cache line with the centre row.
//
// Design: one thread per pixel in 16x16 blocks over [H,W,4] buffers,
// taps read through the read-only cache (__ldg) so that the 16x16 block's
// overlapping footprints hit in L1/L2. An explicit bounds test and
// depth >= 1e-5 form the valid mask. Taps are summed in the order of the
// reference (dy outer, dx inner). Built with --fmad=false.
#include "eaw_common.cuh"

__device__ __forceinline__ double eaw_kw(int a) {
  return a == 0 ? 1.0 : (a == 1 ? 2.0 / 3.0 : 1.0 / 6.0);
}

__global__ void eaw_stage_kernel(const float4* __restrict__ col,
                                 const float4* __restrict__ geo,
                                 float4* __restrict__ out, int height,
                                 int width, int stride, int use_variance,
                                 float s_normal, float s_depth, float s_luma) {
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
      const int t = ty * width + tx;
      const float4 tg = __ldg(&geo[t]);
      if (!(tg.w >= 1e-5f)) continue;
      const float4 tc = __ldg(&col[t]);
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

  float4 o;
  if (g.w < 1e-5f) {
    o = make_float4(cr, cg, cb, cv);
  } else if (tw < EAW_EPS) {
    o = make_float4(cr, cg, cb, cv);
  } else {
    const float inv = 1.0f / fmaxf(tw, EAW_EPS);
    o = make_float4(acc_r * inv, acc_g * inv, acc_b * inv,
                    use_variance ? acc_v * inv * inv : acc_v);
  }
  out[idx] = o;
}

extern "C" int eaw_stage(const float* col, const float* geo, float* out,
                         int height, int width, int stride, int use_variance,
                         float s_normal, float s_depth, float s_luma,
                         int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (height > 0 && width > 0) {
    const dim3 block(EAW_TILE, EAW_TILE);
    const dim3 grid((width + EAW_TILE - 1) / EAW_TILE,
                    (height + EAW_TILE - 1) / EAW_TILE);
    eaw_stage_kernel<<<grid, block, 0, stream>>>(
        reinterpret_cast<const float4*>(col), reinterpret_cast<const float4*>(geo),
        reinterpret_cast<float4*>(out), height, width, stride, use_variance,
        s_normal, s_depth, s_luma);
  }
  return (int)cudaGetLastError();
}
