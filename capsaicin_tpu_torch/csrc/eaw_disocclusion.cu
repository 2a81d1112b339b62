// K3 eaw_disocclusion: the first stage of the EAW denoise chain
// (eaw_blur.hlsl BlurDisocclusion): a 7x7 edge-aware blur with a firefly
// clamp at 10 that, where the temporal history is shorter than 8 frames,
// replaces the variance by one estimated from the blurred spatial moments:
// 8 / hist_len * |m2 - m1^2|. Elsewhere, and on background pixels (depth
// below 1e-5), the pixel passes through, clamped.
//
// Replaces capsaicin_tpu/ops/pallas_stencil.py:_disocc_kernel, which
// reads three planar row windows (color, geo, moments) into VMEM and
// builds its 49 taps from lane rolls.
//
// Bound: the instructions of each tap, not bytes. One thread a pixel with
// taps from the read-only cache spent half its time on the IEEE powf, two
// expf and two divisions of each tap; bounds tests took 3%, the two moment
// sums 7%. With the tap below the special-function unit (lg2 and ex2 a tap)
// and the shared-memory reads bound it, as they bound K5, whose function
// this is without the clamp, the moments and the variance.
//
// Design (K5's, csrc/spatial_gather.cu, with the moments added):
// - The tap of eaw_tap.cuh with the luma term: one lg2.approx and one
//   ex2.approx of a summed exponent, inv_l = log2(e) / s_luma and inv_d =
//   log2(e) / (d0 * s_depth) hoisted. The sums (r, g, b, m1, m2, the
//   weight) and the normals' dot product use __fmaf_rn, taps in the
//   reference's order (dy outer, dx inner); the rest of the file keeps
//   --fmad=false.
// - A block owns a TX x TY output tile. It first reads its outputs'
//   history lengths: where every one is at least 8 (or outside the image),
//   every output passes through, and the block writes them and stages
//   nothing. This is most of a frame once the history has filled.
// - Otherwise it stages its (TX+6) x (TY+6) halo tile in shared memory:
//   geo with cp.async (zero fill outside the image); the colour through
//   registers, clamped to 10 and stored as (r, g, b, luminance), the
//   luminance +inf where the pixel is invalid; the moments as (m1, m2),
//   zero outside the image. An invalid tap's exponent is -inf, so it adds
//   nothing, and every staged value it meets is finite. The centre's
//   variance and history length are read from device memory.
// - A thread computes ROWS vertically adjacent outputs: (ROWS + 6) x 7
//   reads of three staged arrays for ROWS x 49 taps, free of bank
//   conflicts (a warp is one row).
// - Any H and W; the launch plan (grid, tiles a row, dynamic shared bytes)
//   comes from ops/stencil.py:disocc_plan, which the kernel trusts.
// Two instances: float32 storage, and bf16 storage (arithmetic in float32,
// the output rounded to bf16).
#include "eaw_tap.cuh"

#define K3_TX 32  // output columns a block (= blockDim.x: a warp is a row)
#define K3_TY 8   // output rows a block
#define K3_ROWS 2  // outputs a thread, one above the other
#define K3_R 3     // the reach in taps
#define K3_SX (K3_TX + 2 * K3_R)
#define K3_SY (K3_TY + 2 * K3_R)
#define K3_STAGED (K3_SX * K3_SY)
#define K3_THREADS (K3_TX * K3_TY / K3_ROWS)

template <typename S>
__global__ void __launch_bounds__(K3_THREADS)
eaw_disocclusion_kernel(const S* __restrict__ col, const S* __restrict__ geo,
                        const S* __restrict__ mom, S* __restrict__ out, int height, int width,
                        int tiles_x, float s_normal, float s_depth, float s_luma) {
  typedef typename EawRaw4<S>::type Raw;
  extern __shared__ float4 eaw_smem[];
  float4* s_col = eaw_smem;                                     // (r, g, b, luminance or +inf)
  float4* s_geo = s_col + K3_STAGED;                            // (normal, depth)
  float2* s_mom = reinterpret_cast<float2*>(s_geo + K3_STAGED);  // (m1, m2)
  // bf16: the raw geo lands after the float32 arrays; float32: in place
  Raw* raw_geo = reinterpret_cast<Raw*>(s_geo);
  if (sizeof(Raw) != sizeof(float4)) raw_geo = reinterpret_cast<Raw*>(s_mom + K3_STAGED);

  const int x0 = (blockIdx.x % tiles_x) * K3_TX - K3_R;
  const int y0 = (blockIdx.x / tiles_x) * K3_TY - K3_R;
  const int tid = threadIdx.y * K3_TX + threadIdx.x;
  const int tx = threadIdx.x, ty0 = threadIdx.y * K3_ROWS;
  const int x = x0 + K3_R + tx;

  // the outputs' history lengths; a block whose outputs all pass through
  // stages nothing
  float hist[K3_ROWS];
  bool blur = false;
#pragma unroll
  for (int q = 0; q < K3_ROWS; ++q) {
    const int y = y0 + K3_R + ty0 + q;
    hist[q] = EAW_SPATIAL_VARIANCE_THRESHOLD;
    if (x < width && y < height) hist[q] = eaw_load1(mom, 3 * (y * width + x) + 2);
    blur |= !(hist[q] >= EAW_SPATIAL_VARIANCE_THRESHOLD);
  }
  if (!__syncthreads_or(blur)) {
#pragma unroll
    for (int q = 0; q < K3_ROWS; ++q) {
      const int y = y0 + K3_R + ty0 + q;
      if (x >= width || y >= height) continue;
      const int idx = y * width + x;
      const float4 c = eaw_load4(col, idx);
      eaw_store4(out, idx, make_float4(fminf(c.x, EAW_FIREFLY_CLAMP),
                                       fminf(c.y, EAW_FIREFLY_CLAMP),
                                       fminf(c.z, EAW_FIREFLY_CLAMP), c.w));
    }
    return;
  }

  for (int k = tid; k < K3_STAGED; k += K3_THREADS) {
    const int sx = x0 + k % K3_SX, sy = y0 + k / K3_SX;
    const bool inside = sx >= 0 && sx < width && sy >= 0 && sy < height;
    eaw_stage4_async(raw_geo + k, geo, inside ? sy * width + sx : 0, inside);
  }
  for (int k = tid; k < K3_STAGED; k += K3_THREADS) {
    const int sx = x0 + k % K3_SX, sy = y0 + k / K3_SX;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 mo = make_float2(0.0f, 0.0f);
    if (sx >= 0 && sx < width && sy >= 0 && sy < height) {
      const int i = sy * width + sx;
      c = eaw_load4(col, i);
      mo = make_float2(eaw_load1(mom, 3 * i), eaw_load1(mom, 3 * i + 1));
    }
    const float r = fminf(c.x, EAW_FIREFLY_CLAMP);
    const float g = fminf(c.y, EAW_FIREFLY_CLAMP);
    const float b = fminf(c.z, EAW_FIREFLY_CLAMP);
    s_col[k] = make_float4(r, g, b, eaw_lum(r, g, b));
    s_mom[k] = mo;
  }
  eaw_stage_wait();
  for (int k = tid; k < K3_STAGED; k += K3_THREADS) {
    const float4 gk = eaw_widen4(raw_geo[k]);
    if (!(gk.w >= 1e-5f)) s_col[k].w = __int_as_float(0x7f800000);
    s_geo[k] = gk;
  }
  __syncthreads();

  const float nfloor = s_normal == 0.0f ? 1.0f : 0.0f;
  const float inv_l = fmaxf(EAW_LOG2E / s_luma, EAW_TAP_INV_L_MIN);
  EawCentre c[K3_ROWS];
  float3 cc[K3_ROWS];
  bool live[K3_ROWS];
  bool any_live = false;
#pragma unroll
  for (int q = 0; q < K3_ROWS; ++q) {
    const int ci = (ty0 + q + K3_R) * K3_SX + tx + K3_R;
    const float4 g = s_geo[ci];
    const float4 cl = s_col[ci];
    cc[q] = make_float3(cl.x, cl.y, cl.z);
    const int y = y0 + K3_R + ty0 + q;
    // the reference blurs where the depth is not below 1e-5 and the history
    // is shorter than 8
    live[q] = x < width && y < height && !(g.w < 1e-5f) &&
              !(hist[q] >= EAW_SPATIAL_VARIANCE_THRESHOLD);
    any_live |= live[q];
    const float s_d_base = g.w * s_depth;
    c[q] = EawCentre{g.x, g.y, g.z, g.w, cl.w,
                     s_d_base == 0.0f ? 0.0f : EAW_LOG2E / s_d_base, inv_l};
  }

  float acc_r[K3_ROWS], acc_g[K3_ROWS], acc_b[K3_ROWS], acc_m1[K3_ROWS], acc_m2[K3_ROWS],
      tw[K3_ROWS];
#pragma unroll
  for (int q = 0; q < K3_ROWS; ++q)
    acc_r[q] = acc_g[q] = acc_b[q] = acc_m1[q] = acc_m2[q] = tw[q] = 0.0f;
  if (any_live) {
#pragma unroll
    for (int r = 0; r < K3_ROWS + 2 * K3_R; ++r) {
#pragma unroll
      for (int dx = -K3_R; dx <= K3_R; ++dx) {
        const int t = (ty0 + r) * K3_SX + tx + K3_R + dx;
        const float4 tc = s_col[t];
        const float4 tg = s_geo[t];
        const float2 tm = s_mom[t];
#pragma unroll
        for (int q = 0; q < K3_ROWS; ++q) {
          const int dy = r - K3_R - q;
          if (dy < -K3_R || dy > K3_R) continue;
          const float w =
              eaw_ex2(eaw_tap_exponent<true>(c[q], tg, tc.w, dx, dy, s_normal, nfloor, 0.0f));
          acc_r[q] = __fmaf_rn(w, tc.x, acc_r[q]);
          acc_g[q] = __fmaf_rn(w, tc.y, acc_g[q]);
          acc_b[q] = __fmaf_rn(w, tc.z, acc_b[q]);
          acc_m1[q] = __fmaf_rn(w, tm.x, acc_m1[q]);
          acc_m2[q] = __fmaf_rn(w, tm.y, acc_m2[q]);
          tw[q] += w;
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < K3_ROWS; ++q) {
    const int y = y0 + K3_R + ty0 + q;
    if (x >= width || y >= height) continue;
    const int idx = y * width + x;
    float4 o = make_float4(cc[q].x, cc[q].y, cc[q].z, eaw_load1(col, 4 * idx + 3));
    if (live[q]) {
      const bool low = tw[q] < EAW_EPS;
      const float inv = 1.0f / fmaxf(tw[q], EAW_EPS);
      const float f_m1 = low ? 0.0f : acc_m1[q] * inv;
      const float f_m2 = low ? 0.0f : acc_m2[q] * inv;
      const float boost = EAW_SPATIAL_VARIANCE_THRESHOLD / fmaxf(hist[q], 1e-5f);
      o.w = boost * fabsf(f_m2 - f_m1 * f_m1);
      if (!low) {
        o.x = acc_r[q] * inv;
        o.y = acc_g[q] * inv;
        o.z = acc_b[q] * inv;
      }
    }
    eaw_store4(out, idx, o);
  }
}

template <typename S>
static void* eaw_disocclusion_fn() {
  return reinterpret_cast<void*>(eaw_disocclusion_kernel<S>);
}

// One launch of the plan disocc_plan gives: `grid` blocks of K3_THREADS,
// `tiles_x` output tiles a row, `shared` dynamic bytes.
template <typename S>
static int launch_eaw_disocclusion(const void* col, const void* geo, const void* mom, void* out,
                                   int height, int width, float s_normal, float s_depth,
                                   float s_luma, int grid, int tiles_x, int shared, int device,
                                   cudaStream_t stream) {
  cudaSetDevice(device);
  if (grid > 0)
    eaw_disocclusion_kernel<S><<<grid, dim3(K3_TX, K3_TY / K3_ROWS), shared, stream>>>(
        static_cast<const S*>(col), static_cast<const S*>(geo), static_cast<const S*>(mom),
        static_cast<S*>(out), height, width, tiles_x, s_normal, s_depth, s_luma);
  return (int)cudaGetLastError();
}

extern "C" int eaw_disocclusion(const void* col, const void* geo, const void* mom, void* out,
                                int height, int width, float s_normal, float s_depth,
                                float s_luma, int grid, int tiles_x, int shared, int device,
                                cudaStream_t stream) {
  return launch_eaw_disocclusion<float>(col, geo, mom, out, height, width, s_normal, s_depth,
                                        s_luma, grid, tiles_x, shared, device, stream);
}

extern "C" int eaw_disocclusion_bf16(const void* col, const void* geo, const void* mom, void* out,
                                     int height, int width, float s_normal, float s_depth,
                                     float s_luma, int grid, int tiles_x, int shared, int device,
                                     cudaStream_t stream) {
  return launch_eaw_disocclusion<__nv_bfloat16>(col, geo, mom, out, height, width, s_normal,
                                                s_depth, s_luma, grid, tiles_x, shared, device,
                                                stream);
}

// K3's build on `device` with `shared` dynamic bytes a block; `out` as
// eaw_stage_info gives it.
extern "C" int eaw_disocclusion_info(int bf16, int shared, int* out, int device) {
  cudaSetDevice(device);
  const void* fn = bf16 ? eaw_disocclusion_fn<__nv_bfloat16>() : eaw_disocclusion_fn<float>();
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, K3_THREADS, shared);
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
