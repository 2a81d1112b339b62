// K6 eaw_pair: two a-trous stages of the EAW denoise chain in one launch
// (the eaw_fused option): stage A at stride_a, then stage B at stride_b
// on stage A's output, which never goes to device memory. Each stage is
// eaw_blur.hlsl Blur, the body K4 runs (eaw_stage_pixel).
//
// Replaces capsaicin_tpu/ops/pallas_stencil.py:_eaw_pair_kernel, which
// computes stage A over the row slab stage B's taps reach, keeps it in
// VMEM and runs stage B from there.
//
// Bound: the powf/expf of each tap. Two sequential K4 launches read color
// and geo twice and write an intermediate image; the pair reads them once
// and writes once, but recomputes stage A on the halo of every tile.
//
// Design: a 16x16 thread block owns a 16x16 output tile. It first computes
// stage A over the tile plus a 2*stride_b halo on each side, (16 +
// 4*stride_b)^2 pixels, into dynamic shared memory as float32 (for (5, 7):
// 44^2 * 16 B = 31 KB; for (1, 3): 28^2 * 16 B = 12.5 KB), each thread
// taking every 256th pixel of the span. Stage-A pixels outside the image
// are not computed: stage B tests the bounds of its taps before reading
// them. After a barrier, each thread runs stage B for its pixel with its
// color taps from shared memory and geo from device memory. The
// intermediate stays float32 under bf16 storage too: only the output is
// rounded, as in the Pallas kernel. Built with --fmad=false.
#include "eaw_common.cuh"

// Color taps of stage B, read from stage A's tile in shared memory; (x0,
// y0) is the image position of the span's first pixel.
struct EawSharedColor {
  const float4* p;
  int x0, y0, span;
  __device__ __forceinline__ float4 operator()(int x, int y) const {
    return p[(y - y0) * span + (x - x0)];
  }
};

template <typename S>
__global__ void eaw_pair_kernel(const S* __restrict__ col,
                                const S* __restrict__ geo, S* __restrict__ out,
                                int height, int width, int stride_a,
                                int stride_b, int use_variance, float s_normal,
                                float s_depth, float s_luma) {
  extern __shared__ float4 eaw_mid[];
  const int halo = 2 * stride_b;
  const int span = EAW_TILE + 2 * halo;
  const int x0 = blockIdx.x * EAW_TILE - halo;
  const int y0 = blockIdx.y * EAW_TILE - halo;
  const EawGlobalColor<S> col_at{col, width};
  for (int i = threadIdx.y * EAW_TILE + threadIdx.x; i < span * span;
       i += EAW_TILE * EAW_TILE) {
    const int gx = x0 + i % span;
    const int gy = y0 + i / span;
    if (gx >= 0 && gx < width && gy >= 0 && gy < height) {
      eaw_mid[i] = eaw_stage_pixel(col_at, geo, gx, gy, height, width,
                                   stride_a, use_variance, s_normal, s_depth,
                                   s_luma);
    }
  }
  __syncthreads();

  const int x = blockIdx.x * EAW_TILE + threadIdx.x;
  const int y = blockIdx.y * EAW_TILE + threadIdx.y;
  if (x >= width || y >= height) return;
  eaw_store4(out, y * width + x,
             eaw_stage_pixel(EawSharedColor{eaw_mid, x0, y0, span}, geo, x, y,
                             height, width, stride_b, use_variance, s_normal,
                             s_depth, s_luma));
}

// Shared memory a block needs for stage A's tile at stride_b.
static size_t eaw_pair_smem(int stride_b) {
  const size_t span = EAW_TILE + 4 * (size_t)stride_b;
  return span * span * sizeof(float4);
}

template <typename S>
static int launch_eaw_pair(const void* col, const void* geo, void* out,
                           int height, int width, int stride_a, int stride_b,
                           int use_variance, float s_normal, float s_depth,
                           float s_luma, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  // above 48 KB a block needs an opt-in this kernel does not make
  if (stride_a < 1 || stride_b < 1 || eaw_pair_smem(stride_b) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (height > 0 && width > 0) {
    const dim3 block(EAW_TILE, EAW_TILE);
    const dim3 grid((width + EAW_TILE - 1) / EAW_TILE,
                    (height + EAW_TILE - 1) / EAW_TILE);
    eaw_pair_kernel<S><<<grid, block, eaw_pair_smem(stride_b), stream>>>(
        static_cast<const S*>(col), static_cast<const S*>(geo),
        static_cast<S*>(out), height, width, stride_a, stride_b, use_variance,
        s_normal, s_depth, s_luma);
  }
  return (int)cudaGetLastError();
}

extern "C" int eaw_pair(const void* col, const void* geo, void* out,
                        int height, int width, int stride_a, int stride_b,
                        int use_variance, float s_normal, float s_depth,
                        float s_luma, int device, cudaStream_t stream) {
  return launch_eaw_pair<float>(col, geo, out, height, width, stride_a,
                                stride_b, use_variance, s_normal, s_depth,
                                s_luma, device, stream);
}

extern "C" int eaw_pair_bf16(const void* col, const void* geo, void* out,
                             int height, int width, int stride_a,
                             int stride_b, int use_variance, float s_normal,
                             float s_depth, float s_luma, int device,
                             cudaStream_t stream) {
  return launch_eaw_pair<__nv_bfloat16>(col, geo, out, height, width,
                                        stride_a, stride_b, use_variance,
                                        s_normal, s_depth, s_luma, device,
                                        stream);
}
