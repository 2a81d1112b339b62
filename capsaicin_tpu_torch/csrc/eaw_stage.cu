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
// four-channel pixels (color, geo) and writes one; the chain runs it at
// strides 1, 3, 5 and 7, so at wide strides neighbouring threads' taps
// share no cache line with the centre row.
//
// Design: one thread per pixel in 16x16 blocks over [H,W,4] buffers,
// taps read through the read-only cache (__ldg) so that the 16x16 block's
// overlapping footprints hit in L1/L2. The stage body (eaw_stage_pixel in
// eaw_common.cuh) is shared with K6. Two instances: float32 storage, and
// bf16 storage (eaw_bf16: half the bytes, arithmetic in float32, the
// output rounded to bf16). Built with --fmad=false.
#include "eaw_common.cuh"

template <typename S>
__global__ void eaw_stage_kernel(const S* __restrict__ col,
                                 const S* __restrict__ geo, S* __restrict__ out,
                                 int height, int width, int stride,
                                 int use_variance, float s_normal,
                                 float s_depth, float s_luma) {
  const int x = blockIdx.x * EAW_TILE + threadIdx.x;
  const int y = blockIdx.y * EAW_TILE + threadIdx.y;
  if (x >= width || y >= height) return;
  eaw_store4(out, y * width + x,
             eaw_stage_pixel(EawGlobalColor<S>{col, width}, geo, x, y, height,
                             width, stride, use_variance, s_normal, s_depth,
                             s_luma));
}

template <typename S>
static int launch_eaw_stage(const void* col, const void* geo, void* out,
                            int height, int width, int stride, int use_variance,
                            float s_normal, float s_depth, float s_luma,
                            int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (height > 0 && width > 0) {
    const dim3 block(EAW_TILE, EAW_TILE);
    const dim3 grid((width + EAW_TILE - 1) / EAW_TILE,
                    (height + EAW_TILE - 1) / EAW_TILE);
    eaw_stage_kernel<S><<<grid, block, 0, stream>>>(
        static_cast<const S*>(col), static_cast<const S*>(geo),
        static_cast<S*>(out), height, width, stride, use_variance, s_normal,
        s_depth, s_luma);
  }
  return (int)cudaGetLastError();
}

extern "C" int eaw_stage(const void* col, const void* geo, void* out,
                         int height, int width, int stride, int use_variance,
                         float s_normal, float s_depth, float s_luma,
                         int device, cudaStream_t stream) {
  return launch_eaw_stage<float>(col, geo, out, height, width, stride,
                                 use_variance, s_normal, s_depth, s_luma,
                                 device, stream);
}

extern "C" int eaw_stage_bf16(const void* col, const void* geo, void* out,
                              int height, int width, int stride,
                              int use_variance, float s_normal, float s_depth,
                              float s_luma, int device, cudaStream_t stream) {
  return launch_eaw_stage<__nv_bfloat16>(col, geo, out, height, width, stride,
                                         use_variance, s_normal, s_depth,
                                         s_luma, device, stream);
}
