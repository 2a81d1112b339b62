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
// Bound: the instructions of each tap, not bytes. One thread a pixel with
// taps from the read-only cache spends about 230 warp instructions a tap:
// IEEE powf and two expf, two divisions, four bounds tests, three scalar
// loads of the 12-byte indirect and its luminance. With the tap below the
// special-function unit (lg2 and ex2 a tap) bounds it.
//
// Design:
// - The tap of eaw_tap.cuh with the luma term: one lg2.approx and one
//   ex2.approx of a summed exponent, inv_l = log2(e) / s_luma and inv_d =
//   log2(e) / (d0 * s_depth) hoisted. The sums and the normals' dot product
//   use __fmaf_rn, taps in the reference's order (dy outer, dx inner); the
//   rest of the file keeps --fmad=false.
// - A block owns a TX x TY output tile and stages its (TX+6) x (TY+6) halo
//   tile into shared memory: geo with cp.async (zero fill outside the
//   image), the 12-byte (bf16: 6-byte) indirect pixel through registers,
//   widened to float4 (r, g, b, luminance), the luminance +inf where the
//   pixel is invalid. Each tap is then two float4 reads of shared memory,
//   free of bank conflicts (a warp is one row), and no bounds test.
// - A thread computes ROWS vertically adjacent outputs: (ROWS + 6) x 7
//   reads for ROWS x 49 taps.
// - Any H and W (the half-resolution gather of lowres_indirect included);
//   the launch plan (grid, tiles a row, dynamic shared bytes) comes from
//   ops/stencil.py:gather_plan, which the kernel trusts.
// Two instances: float32 storage, and bf16 storage (arithmetic in float32,
// the output rounded to bf16).
#include "eaw_tap.cuh"

#define K5_TX 32  // output columns a block (= blockDim.x: a warp is a row)
#define K5_TY 8   // output rows a block
#define K5_ROWS 2  // outputs a thread, one above the other
#define K5_R 3     // the reach in taps
#define K5_SX (K5_TX + 2 * K5_R)
#define K5_SY (K5_TY + 2 * K5_R)
#define K5_STAGED (K5_SX * K5_SY)
#define K5_THREADS (K5_TX * K5_TY / K5_ROWS)

template <typename S>
__global__ void __launch_bounds__(K5_THREADS)
spatial_gather_kernel(const S* __restrict__ in, const S* __restrict__ geo, S* __restrict__ out,
                      int height, int width, int tiles_x, float s_normal, float s_depth,
                      float s_luma) {
  typedef typename EawRaw4<S>::type Raw;
  extern __shared__ float4 eaw_smem[];
  float4* s_col = eaw_smem;           // (r, g, b, luminance or +inf)
  float4* s_geo = s_col + K5_STAGED;  // (normal, depth)
  // bf16: the raw geo lands after the float32 arrays; float32: in place
  Raw* raw_geo = reinterpret_cast<Raw*>(s_geo);
  if (sizeof(Raw) != sizeof(float4)) raw_geo = reinterpret_cast<Raw*>(s_geo + K5_STAGED);

  const int x0 = (blockIdx.x % tiles_x) * K5_TX - K5_R;
  const int y0 = (blockIdx.x / tiles_x) * K5_TY - K5_R;
  const int tid = threadIdx.y * K5_TX + threadIdx.x;

  for (int k = tid; k < K5_STAGED; k += K5_THREADS) {
    const int x = x0 + k % K5_SX, y = y0 + k / K5_SX;
    const bool inside = x >= 0 && x < width && y >= 0 && y < height;
    eaw_stage4_async(raw_geo + k, geo, inside ? y * width + x : 0, inside);
  }
  for (int k = tid; k < K5_STAGED; k += K5_THREADS) {
    const int x = x0 + k % K5_SX, y = y0 + k / K5_SX;
    float r = 0.0f, g = 0.0f, b = 0.0f;
    if (x >= 0 && x < width && y >= 0 && y < height) {
      const int i = 3 * (y * width + x);
      r = eaw_load1(in, i);
      g = eaw_load1(in, i + 1);
      b = eaw_load1(in, i + 2);
    }
    s_col[k] = make_float4(r, g, b, eaw_lum(r, g, b));
  }
  eaw_stage_wait();
  for (int k = tid; k < K5_STAGED; k += K5_THREADS) {
    const float4 gk = eaw_widen4(raw_geo[k]);
    if (!(gk.w >= 1e-5f)) s_col[k].w = __int_as_float(0x7f800000);
    s_geo[k] = gk;
  }
  __syncthreads();

  const float nfloor = s_normal == 0.0f ? 1.0f : 0.0f;
  const float inv_l = fmaxf(EAW_LOG2E / s_luma, EAW_TAP_INV_L_MIN);
  const int tx = threadIdx.x, ty0 = threadIdx.y * K5_ROWS;
  const int x = x0 + K5_R + tx;
  EawCentre c[K5_ROWS];
  float3 cc[K5_ROWS];
  bool live[K5_ROWS];
  bool any_live = false;
#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q) {
    const int ci = (ty0 + q + K5_R) * K5_SX + tx + K5_R;
    const float4 g = s_geo[ci];
    const float4 col = s_col[ci];
    cc[q] = make_float3(col.x, col.y, col.z);
    const int y = y0 + K5_R + ty0 + q;
    live[q] = x < width && y < height && g.w >= 1e-5f;
    any_live |= live[q];
    const float s_d_base = g.w * s_depth;
    c[q] = EawCentre{g.x, g.y, g.z, g.w, col.w,
                     s_d_base == 0.0f ? 0.0f : EAW_LOG2E / s_d_base, inv_l};
  }

  float acc_r[K5_ROWS], acc_g[K5_ROWS], acc_b[K5_ROWS], tw[K5_ROWS];
#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q) acc_r[q] = acc_g[q] = acc_b[q] = tw[q] = 0.0f;
  if (any_live) {
#pragma unroll
    for (int r = 0; r < K5_ROWS + 2 * K5_R; ++r) {
#pragma unroll
      for (int dx = -K5_R; dx <= K5_R; ++dx) {
        const int t = (ty0 + r) * K5_SX + tx + K5_R + dx;
        const float4 tc = s_col[t];
        const float4 tg = s_geo[t];
#pragma unroll
        for (int q = 0; q < K5_ROWS; ++q) {
          const int dy = r - K5_R - q;
          if (dy < -K5_R || dy > K5_R) continue;
          const float w =
              eaw_ex2(eaw_tap_exponent<true>(c[q], tg, tc.w, dx, dy, s_normal, nfloor, 0.0f));
          acc_r[q] = __fmaf_rn(w, tc.x, acc_r[q]);
          acc_g[q] = __fmaf_rn(w, tc.y, acc_g[q]);
          acc_b[q] = __fmaf_rn(w, tc.z, acc_b[q]);
          tw[q] += w;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < K5_ROWS; ++q) {
    const int y = y0 + K5_R + ty0 + q;
    if (x >= width || y >= height) continue;
    float3 o = cc[q];
    if (live[q] && !(tw[q] < EAW_EPS)) {
      const float inv = 1.0f / fmaxf(tw[q], EAW_EPS);
      o = make_float3(acc_r[q] * inv, acc_g[q] * inv, acc_b[q] * inv);
    }
    const int i = 3 * (y * width + x);
    eaw_store1(out, i, o.x);
    eaw_store1(out, i + 1, o.y);
    eaw_store1(out, i + 2, o.z);
  }
}

template <typename S>
static void* spatial_gather_fn() {
  return reinterpret_cast<void*>(spatial_gather_kernel<S>);
}

// One launch of the plan gather_plan gives: `grid` blocks of K5_THREADS,
// `tiles_x` output tiles a row, `shared` dynamic bytes.
template <typename S>
static int launch_spatial_gather(const void* in, const void* geo, void* out, int height,
                                 int width, float s_normal, float s_depth, float s_luma,
                                 int grid, int tiles_x, int shared, int device,
                                 cudaStream_t stream) {
  cudaSetDevice(device);
  if (grid > 0)
    spatial_gather_kernel<S><<<grid, dim3(K5_TX, K5_TY / K5_ROWS), shared, stream>>>(
        static_cast<const S*>(in), static_cast<const S*>(geo), static_cast<S*>(out), height,
        width, tiles_x, s_normal, s_depth, s_luma);
  return (int)cudaGetLastError();
}

extern "C" int spatial_gather(const void* in, const void* geo, void* out, int height, int width,
                              float s_normal, float s_depth, float s_luma, int grid, int tiles_x,
                              int shared, int device, cudaStream_t stream) {
  return launch_spatial_gather<float>(in, geo, out, height, width, s_normal, s_depth, s_luma,
                                      grid, tiles_x, shared, device, stream);
}

extern "C" int spatial_gather_bf16(const void* in, const void* geo, void* out, int height,
                                   int width, float s_normal, float s_depth, float s_luma,
                                   int grid, int tiles_x, int shared, int device,
                                   cudaStream_t stream) {
  return launch_spatial_gather<__nv_bfloat16>(in, geo, out, height, width, s_normal, s_depth,
                                              s_luma, grid, tiles_x, shared, device, stream);
}

// K5's build on `device` with `shared` dynamic bytes a block; `out` as
// eaw_stage_info gives it.
extern "C" int spatial_gather_info(int bf16, int shared, int* out, int device) {
  cudaSetDevice(device);
  const void* fn = bf16 ? spatial_gather_fn<__nv_bfloat16>() : spatial_gather_fn<float>();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, K5_THREADS, shared);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = shared;
  out[4] = blocks;
  out[5] = sms;
  return (int)cudaSuccess;
}
