// K4 eaw_stage: one 5x5 a-trous stage of the EAW denoise chain
// (eaw_blur.hlsl Blur): weights (1, 2/3, 1/6) per axis, normal and depth
// edge stopping, a luma sigma scaled by the variance, and the variance
// filtered with the squared weights.
//
// Replaces capsaicin_tpu/ops/pallas_stencil.py:_eaw_kernel (its body is
// _eaw_stage), which reads row tiles of a column-padded planar layout into
// VMEM and builds the taps from lane rolls.
//
// Bound: the instructions of each tap, not bytes. One thread a pixel with
// taps from the read-only cache spends about 200 warp instructions a tap on
// IEEE powf/expf, two divisions, four bounds tests and a luminance and bf16
// widening per tap; the intrinsics alone halve its time, while cutting its
// bytes to the centre pixel does not help. What is left after the tap below
// is the shared-memory reads, the special-function unit and, at strides
// above 1, the staging's reads, which use half of each 32-byte sector.
//
// Design:
// - The tap of eaw_tap.cuh: one lg2.approx and one ex2.approx of a summed
//   exponent, reciprocals hoisted per pixel, hw as a log2 constant, and
//   hw_w^2 * lw^2 = w_full^2, so the variance adds w_full^2 * v. The sums
//   (and the normals' dot product) use __fmaf_rn, in the reference's order:
//   dy outer, dx inner. The rest of the file keeps --fmad=false.
// - Every tap of a stride-s stage at (x, y) lies on the sub-lattice
//   (x mod s, y mod s). A block takes one phase (px, py) and a TX x TY
//   patch of that lattice, and stages the patch's (TX+4) x (TY+4) lattice
//   pixels of colour and geo into shared memory with cp.async (zero fill
//   outside the image), whatever the stride. Then each thread widens and
//   converts the pixels it staged, once: clamped rgb, the variance, the
//   luminance (+inf where the pixel is invalid), geo. Taps read float4s
//   from shared memory; a warp is one lattice row, so they are free of bank
//   conflicts.
// - A thread computes ROWS vertically adjacent outputs, so the taps the
//   two share are read once: (ROWS + 4) x 5 reads for ROWS x 25 taps.
// - The block index runs over phases fastest, so the s^2 phases of one
//   image region run together and share its cache lines in L2.
// - The launch plan (grid, lattice tiles per row, dynamic shared bytes)
//   comes from ops/stencil.py:stage_plan, which the kernel trusts.
// Four instances: float32 or bf16 storage (arithmetic in float32, the
// output rounded to bf16), with or without the variance.
#include "eaw_tap.cuh"

#define K4_TX 32  // lattice columns a block (= blockDim.x: a warp is a row)
#define K4_TY 16  // lattice rows a block
#define K4_ROWS 2  // outputs a thread, one above the other
#define K4_R 2     // the reach in taps
#define K4_SX (K4_TX + 2 * K4_R)
#define K4_SY (K4_TY + 2 * K4_R)
#define K4_STAGED (K4_SX * K4_SY)
#define K4_THREADS (K4_TX * K4_TY / K4_ROWS)
#define K4_MIN_BLOCKS 4  // resident blocks an SM: at most 64 registers a thread

template <typename S, bool VAR>
__global__ void __launch_bounds__(K4_THREADS, K4_MIN_BLOCKS)
eaw_stage_kernel(const S* __restrict__ col, const S* __restrict__ geo, S* __restrict__ out,
                 int height, int width, int stride, int tiles_x, float s_normal, float s_depth,
                 float s_luma) {
  typedef typename EawRaw4<S>::type Raw;
  extern __shared__ float4 eaw_smem[];
  float4* s_col = eaw_smem;               // (r, g, b, v), or (r, g, b, 0 / -inf)
  float4* s_geo = s_col + K4_STAGED;      // (normal, depth)
  float* s_lum = reinterpret_cast<float*>(s_geo + K4_STAGED);  // luminance / +inf, or v
  // bf16: the raw pixels land after the float32 arrays; float32: in place
  Raw* raw_col = reinterpret_cast<Raw*>(s_col);
  Raw* raw_geo = reinterpret_cast<Raw*>(s_geo);
  if (sizeof(Raw) != sizeof(float4)) {
    raw_col = reinterpret_cast<Raw*>(s_lum + K4_STAGED);
    raw_geo = raw_col + K4_STAGED;
  }

  const int phases = stride * stride;
  const int phase = blockIdx.x % phases;
  const int tile = blockIdx.x / phases;
  const int px = phase % stride, py = phase / stride;
  const int i0 = (tile % tiles_x) * K4_TX, j0 = (tile / tiles_x) * K4_TY;
  const int tid = threadIdx.y * K4_TX + threadIdx.x;

  // stage the patch and its reach; each thread converts what it staged
  for (int k = tid; k < K4_STAGED; k += K4_THREADS) {
    const int x = px + stride * (i0 - K4_R + k % K4_SX);
    const int y = py + stride * (j0 - K4_R + k / K4_SX);
    const bool inside = x >= 0 && x < width && y >= 0 && y < height;
    const int idx = inside ? y * width + x : 0;
    eaw_stage4_async(raw_col + k, col, idx, inside);
    eaw_stage4_async(raw_geo + k, geo, idx, inside);
  }
  eaw_stage_wait();
  for (int k = tid; k < K4_STAGED; k += K4_THREADS) {
    const float4 c = eaw_widen4(raw_col[k]);
    const float4 g = eaw_widen4(raw_geo[k]);
    const float r = fminf(c.x, EAW_FIREFLY_CLAMP), gr = fminf(c.y, EAW_FIREFLY_CLAMP),
                b = fminf(c.z, EAW_FIREFLY_CLAMP);
    const bool valid = g.w >= 1e-5f;
    if (VAR) {
      s_col[k] = make_float4(r, gr, b, c.w);
      s_lum[k] = valid ? eaw_lum(r, gr, b) : __int_as_float(0x7f800000);
    } else {
      s_col[k] = make_float4(r, gr, b, valid ? 0.0f : -__int_as_float(0x7f800000));
      s_lum[k] = c.w;
    }
    s_geo[k] = g;
  }
  __syncthreads();

  const float nfloor = s_normal == 0.0f ? 1.0f : 0.0f;
  const int tx = threadIdx.x, ty0 = threadIdx.y * K4_ROWS;
  const int x = px + stride * (i0 + tx);
  EawCentre c[K4_ROWS];
  float4 cc[K4_ROWS];
  float cv[K4_ROWS];
  bool live[K4_ROWS];
  bool any_live = false;
#pragma unroll
  for (int q = 0; q < K4_ROWS; ++q) {
    const int ci = (ty0 + q + K4_R) * K4_SX + tx + K4_R;
    const float4 g = s_geo[ci];
    cc[q] = s_col[ci];
    cv[q] = VAR ? cc[q].w : s_lum[ci];
    const int y = py + stride * (j0 + ty0 + q);
    live[q] = x < width && y < height && g.w >= 1e-5f;
    any_live |= live[q];
    const float s_d_base = g.w * (float)stride * s_depth;
    const float s_l_eff = s_luma * sqrtf(fmaxf(0.0f, cv[q] + EAW_EPS));
    c[q] = EawCentre{g.x, g.y, g.z, g.w, VAR ? s_lum[ci] : 0.0f,
                     s_d_base == 0.0f ? 0.0f : EAW_LOG2E / s_d_base,
                     fmaxf(EAW_LOG2E / s_l_eff, EAW_TAP_INV_L_MIN)};
  }

  float acc_r[K4_ROWS], acc_g[K4_ROWS], acc_b[K4_ROWS], acc_v[K4_ROWS], tw[K4_ROWS];
#pragma unroll
  for (int q = 0; q < K4_ROWS; ++q) acc_r[q] = acc_g[q] = acc_b[q] = acc_v[q] = tw[q] = 0.0f;
  if (any_live) {
#pragma unroll
    for (int r = 0; r < K4_ROWS + 2 * K4_R; ++r) {
#pragma unroll
      for (int dx = -K4_R; dx <= K4_R; ++dx) {
        const int t = (ty0 + r) * K4_SX + tx + K4_R + dx;
        const float4 tc = s_col[t];
        const float4 tg = s_geo[t];
        const float tl = VAR ? s_lum[t] : 0.0f;
#pragma unroll
        for (int q = 0; q < K4_ROWS; ++q) {
          const int dy = r - K4_R - q;
          if (dy < -K4_R || dy > K4_R) continue;
          const int ax = dx < 0 ? -dx : dx, ay = dy < 0 ? -dy : dy;
          float e = eaw_tap_exponent<VAR>(c[q], tg, tl, dx, dy, s_normal, nfloor,
                                          VAR ? eaw_log2_kw(ax) + eaw_log2_kw(ay) : 0.0f);
          if (!VAR) e += tc.w;
          const float w = eaw_ex2(e);
          acc_r[q] = __fmaf_rn(w, tc.x, acc_r[q]);
          acc_g[q] = __fmaf_rn(w, tc.y, acc_g[q]);
          acc_b[q] = __fmaf_rn(w, tc.z, acc_b[q]);
          tw[q] += w;
          if (VAR) acc_v[q] = __fmaf_rn(w * w, tc.w, acc_v[q]);
        }
      }
    }
  }

#pragma unroll
  for (int q = 0; q < K4_ROWS; ++q) {
    const int y = py + stride * (j0 + ty0 + q);
    if (x >= width || y >= height) continue;
    float4 o = make_float4(cc[q].x, cc[q].y, cc[q].z, cv[q]);
    if (live[q] && !(tw[q] < EAW_EPS)) {
      const float inv = 1.0f / fmaxf(tw[q], EAW_EPS);
      o = make_float4(acc_r[q] * inv, acc_g[q] * inv, acc_b[q] * inv,
                      VAR ? acc_v[q] * inv * inv : 0.0f);
    }
    eaw_store4(out, y * width + x, o);
  }
}

template <typename S>
static void* eaw_stage_fn(int use_variance) {
  return use_variance ? reinterpret_cast<void*>(eaw_stage_kernel<S, true>)
                      : reinterpret_cast<void*>(eaw_stage_kernel<S, false>);
}

// One launch of the plan stage_plan gives: `grid` blocks of K4_THREADS,
// `tiles_x` lattice tiles a row, `shared` dynamic bytes.
template <typename S>
static int launch_eaw_stage(const void* col, const void* geo, void* out, int height, int width,
                            int stride, int use_variance, float s_normal, float s_depth,
                            float s_luma, int grid, int tiles_x, int shared, int device,
                            cudaStream_t stream) {
  cudaSetDevice(device);
  if (grid > 0) {
    const dim3 block(K4_TX, K4_TY / K4_ROWS);
    const S* c = static_cast<const S*>(col);
    const S* g = static_cast<const S*>(geo);
    S* o = static_cast<S*>(out);
    if (use_variance)
      eaw_stage_kernel<S, true><<<grid, block, shared, stream>>>(
          c, g, o, height, width, stride, tiles_x, s_normal, s_depth, s_luma);
    else
      eaw_stage_kernel<S, false><<<grid, block, shared, stream>>>(
          c, g, o, height, width, stride, tiles_x, s_normal, s_depth, s_luma);
  }
  return (int)cudaGetLastError();
}

extern "C" int eaw_stage(const void* col, const void* geo, void* out, int height, int width,
                         int stride, int use_variance, float s_normal, float s_depth,
                         float s_luma, int grid, int tiles_x, int shared, int device,
                         cudaStream_t stream) {
  return launch_eaw_stage<float>(col, geo, out, height, width, stride, use_variance, s_normal,
                                 s_depth, s_luma, grid, tiles_x, shared, device, stream);
}

extern "C" int eaw_stage_bf16(const void* col, const void* geo, void* out, int height,
                              int width, int stride, int use_variance, float s_normal,
                              float s_depth, float s_luma, int grid, int tiles_x, int shared,
                              int device, cudaStream_t stream) {
  return launch_eaw_stage<__nv_bfloat16>(col, geo, out, height, width, stride, use_variance,
                                         s_normal, s_depth, s_luma, grid, tiles_x, shared,
                                         device, stream);
}

// K4's build on `device` with `shared` dynamic bytes a block: out[0]
// registers a thread, [1] local bytes a thread, [2] static shared bytes,
// [3] dynamic shared bytes, [4] resident blocks of K4_THREADS an SM, [5]
// the SMs.
extern "C" int eaw_stage_info(int bf16, int use_variance, int shared, int* out, int device) {
  cudaSetDevice(device);
  const void* fn = bf16 ? eaw_stage_fn<__nv_bfloat16>(use_variance) : eaw_stage_fn<float>(use_variance);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, K4_THREADS, shared);
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
