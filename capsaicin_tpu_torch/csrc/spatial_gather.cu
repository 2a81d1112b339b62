// K5 spatial_gather: the 7x7 cross-bilateral filter of the raw indirect
// light (spatial_gather.hlsl): weights normal^s_normal *
// exp(-|d0 - d1| / (d0 * s_depth * r)) * exp(-|l0 - l1| / s_luma) with the
// gather sigmas, valid taps in bounds with depth >= 1e-5, background
// pixels (depth < 1e-5) passed through. It is K3's body without the
// firefly clamp, the moments and the variance.
//
// Replaces capsaicin_tpu/ops/pallas_stencil.py:_gather_kernel, which reads
// a planar row window of the indirect (3 planes) and geo (4 planes) into
// VMEM and builds its 49 taps from lane rolls.
//
// Bound: L2 traffic and the powf/expf of each tap. Each output pixel reads
// 49 taps of geo (four channels) and indirect (three) and writes three
// values; from device memory that is 28 B read and 12 B written a pixel
// in float32.
//
// Design: one thread per pixel in 16x16 blocks over [H,W,C] buffers, taps
// read through the read-only cache (__ldg) so that the block's 22x22
// footprint is served from L1/L2. The 3-channel indirect has no 16-byte
// alignment per pixel, so it is read as scalars; geo as one 4-value load.
// Taps are summed in the reference's order (dy outer, dx inner) and the
// sum is multiplied by 1/max(tw, EPS), as the Pallas kernel does. Any H
// and W (the half-resolution gather of lowres_indirect included). Two
// instances: float32 storage, and bf16 storage (eaw_bf16: arithmetic in
// float32, the output rounded to bf16). Built with --fmad=false.
#include "eaw_common.cuh"

template <typename S>
__global__ void spatial_gather_kernel(const S* __restrict__ in,
                                      const S* __restrict__ geo,
                                      S* __restrict__ out, int height,
                                      int width, float s_normal,
                                      float s_depth, float s_luma) {
  const int x = blockIdx.x * EAW_TILE + threadIdx.x;
  const int y = blockIdx.y * EAW_TILE + threadIdx.y;
  if (x >= width || y >= height) return;
  const int idx = y * width + x;
  const float cr = eaw_load1(in, 3 * idx);
  const float cg = eaw_load1(in, 3 * idx + 1);
  const float cb = eaw_load1(in, 3 * idx + 2);
  const float4 g = eaw_load4(geo, idx);
  const float cl = eaw_lum(cr, cg, cb);
  const float s_d_base = g.w * s_depth;

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, tw = 0.0f;
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
      const float tr = eaw_load1(in, 3 * t);
      const float tgr = eaw_load1(in, 3 * t + 1);
      const float tb = eaw_load1(in, 3 * t + 2);
      const float w = eaw_edge_weight(g, tg, s_normal, s_d_base * eaw_radius(dx, dy));
      const float lw = expf(-fabsf(cl - eaw_lum(tr, tgr, tb)) / s_luma);
      const float w_full = w * lw;
      acc_r += w_full * tr;
      acc_g += w_full * tgr;
      acc_b += w_full * tb;
      tw += w_full;
    }
  }

  float o_r = cr, o_g = cg, o_b = cb;
  if (g.w >= 1e-5f && tw >= EAW_EPS) {
    const float inv = 1.0f / fmaxf(tw, EAW_EPS);
    o_r = acc_r * inv;
    o_g = acc_g * inv;
    o_b = acc_b * inv;
  }
  eaw_store1(out, 3 * idx, o_r);
  eaw_store1(out, 3 * idx + 1, o_g);
  eaw_store1(out, 3 * idx + 2, o_b);
}

template <typename S>
static int launch_spatial_gather(const void* in, const void* geo, void* out,
                                 int height, int width, float s_normal,
                                 float s_depth, float s_luma, int device,
                                 cudaStream_t stream) {
  cudaSetDevice(device);
  if (height > 0 && width > 0) {
    const dim3 block(EAW_TILE, EAW_TILE);
    const dim3 grid((width + EAW_TILE - 1) / EAW_TILE,
                    (height + EAW_TILE - 1) / EAW_TILE);
    spatial_gather_kernel<S><<<grid, block, 0, stream>>>(
        static_cast<const S*>(in), static_cast<const S*>(geo),
        static_cast<S*>(out), height, width, s_normal, s_depth, s_luma);
  }
  return (int)cudaGetLastError();
}

extern "C" int spatial_gather(const void* in, const void* geo, void* out,
                              int height, int width, float s_normal,
                              float s_depth, float s_luma, int device,
                              cudaStream_t stream) {
  return launch_spatial_gather<float>(in, geo, out, height, width, s_normal,
                                      s_depth, s_luma, device, stream);
}

extern "C" int spatial_gather_bf16(const void* in, const void* geo, void* out,
                                   int height, int width, float s_normal,
                                   float s_depth, float s_luma, int device,
                                   cudaStream_t stream) {
  return launch_spatial_gather<__nv_bfloat16>(in, geo, out, height, width,
                                              s_normal, s_depth, s_luma,
                                              device, stream);
}
