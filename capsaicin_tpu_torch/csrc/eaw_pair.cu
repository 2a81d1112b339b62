// K6 eaw_pair: two a-trous stages of the EAW denoise chain in one launch
// (the eaw_fused option): stage A at stride_a, then stage B at stride_b
// on stage A's output, which never goes to device memory. Each stage is
// eaw_blur.hlsl Blur, as K4 computes it.
//
// Replaces capsaicin_tpu/ops/pallas_stencil.py:_eaw_pair_kernel, which
// computes stage A over the row slab stage B's taps reach, keeps it in
// VMEM and runs stage B from there.
//
// Bound: the instructions of the taps. The first design (16x16 output
// tiles, stage A recomputed over a 2 * stride_b halo, each tap with IEEE
// powf/expf and divisions) spent 60% of its time on those transcendentals
// and 34% (pair (1, 3)) to 54% ((5, 7)) on the halo's recompute, measured
// on an H100; cutting its taps' reads to the centre pixel saved nothing.
//
// Design:
// - The tap of eaw_tap.cuh in both stages: one lg2.approx and one
//   ex2.approx of a summed exponent, reciprocals hoisted per pixel, hw as
//   a log2 constant, sums as __fmaf_rn in the reference's order (dy outer,
//   dx inner); an invalid tap's exponent is -inf. The rest of the file
//   keeps --fmad=false.
// - A block of K6_THREADS owns a tile of outputs and computes stage A once
//   over the region its stage-B taps reach (the tile and 2 * stride_b
//   around it) into dynamic shared memory, float32: the clamped colour and
//   variance (16 B) and the luminance, +inf where the pixel is no valid tap
//   (without the variance: 0, or -inf added to the exponent; 4 B). The
//   tile is chosen within the plan's shared-memory budget (above the 48 KB
//   a block gets without an opt-in), so the recompute is the region's area
//   over the tile's (1.43x and 2.17x at the chain's pairs at 1080p,
//   against 3.1x and 7.6x before).
// - Stage A reads its taps from device memory through the read-only cache,
//   out-of-image taps being zeros (depth 0: invalid), and stage B its
//   colour taps from the region in shared memory and its geo taps through
//   the read-only cache. Each pass takes its outputs in the phase order of
//   its stride (every tap of a pixel lies on the pixel's phase lattice),
//   so a warp's 32 outputs are neighbours on one lattice and their taps
//   overlap in L1; a thread computes two outputs one stride apart in a
//   column, reading the 6 x 5 taps of both once (30 reads for 50 taps).
// - The launch plan (ops/stencil.py:pair_plan: tile, tiles a row, grid,
//   shared bytes) comes from Python, and the kernel trusts it.
// Four instances a storage type (float32 or bf16; arithmetic in float32,
// the intermediate kept in float32, the output rounded to bf16): with or
// without the variance. Built with --fmad=false.
#include "eaw_tap.cuh"

#define K6_THREADS 1024  // a block
#define K6_MIN_BLOCKS 1  // resident blocks an SM: 1,024 threads leave 64 registers a thread
#define K6_ROWS 2        // outputs an item, one stride apart in a column
#define K6_R 2           // the reach in taps

// The items of one stride-s pass over an nx x ny rectangle, phase by
// phase: phase ph = (ph % s, ph / s) has the lattice columns i < lx =
// ceil(nx / s) and the row pairs jp < ceil(ceil(ny / s) / 2); its item
// (i, jp) computes the outputs (qx + s i, qy + 2 s jp) and the one s
// below, where they lie in the rectangle.
struct K6Pass {
  int s, nx, ny, lx, per_phase, items;
};

__device__ __forceinline__ K6Pass k6_pass(int s, int nx, int ny) {
  K6Pass p;
  p.s = s;
  p.nx = nx;
  p.ny = ny;
  p.lx = (nx + s - 1) / s;
  const int ly = (ny + s - 1) / s;
  p.per_phase = p.lx * ((ly + 1) / 2);
  p.items = s * s * p.per_phase;
  return p;
}

// The first output (x, y) of item k, rectangle-local; false if outside.
__device__ __forceinline__ bool k6_item(const K6Pass& p, int k, int& x, int& y) {
  const int ph = k / p.per_phase, r = k - ph * p.per_phase;
  const int jp = r / p.lx, i = r - jp * p.lx;
  x = ph % p.s + p.s * i;
  y = ph / p.s + 2 * p.s * jp;
  return x < p.nx && y < p.ny;
}

__device__ __forceinline__ float4 k6_clamped(float4 c) {
  return make_float4(fminf(c.x, EAW_FIREFLY_CLAMP), fminf(c.y, EAW_FIREFLY_CLAMP),
                     fminf(c.z, EAW_FIREFLY_CLAMP), c.w);
}

// A tap's fourth exponent term: with the variance its luminance (+inf where
// invalid), without it 0 or -inf.
template <bool VAR>
__device__ __forceinline__ float k6_aux(float4 clamped, bool valid) {
  if (VAR) return valid ? eaw_lum(clamped.x, clamped.y, clamped.z) : __int_as_float(0x7f800000);
  return valid ? 0.0f : -__int_as_float(0x7f800000);
}

// The centre of an output: its geo, clamped colour and luminance, with the
// reciprocals hoisted.
__device__ __forceinline__ EawCentre k6_centre(float4 g, float4 cc, float lum, int stride,
                                               float s_depth, float s_luma) {
  const float s_d_base = g.w * (float)stride * s_depth;
  const float s_l_eff = s_luma * sqrtf(fmaxf(0.0f, cc.w + EAW_EPS));
  return EawCentre{g.x, g.y, g.z, g.w, lum, s_d_base == 0.0f ? 0.0f : EAW_LOG2E / s_d_base,
                   fmaxf(EAW_LOG2E / s_l_eff, EAW_TAP_INV_L_MIN)};
}

// One tap of (up to) K6_ROWS outputs: the tap at row offset r of the item
// (dy = r - K6_R - q for output q), offset dx, with geo `tg`, clamped colour
// `tc` and exponent term `ta`.
template <bool VAR>
__device__ __forceinline__ void k6_tap(const EawCentre (&c)[K6_ROWS], int r, int dx, float4 tg,
                                       float4 tc, float ta, float s_normal, float nfloor,
                                       float (&acc_r)[K6_ROWS], float (&acc_g)[K6_ROWS],
                                       float (&acc_b)[K6_ROWS], float (&acc_v)[K6_ROWS],
                                       float (&tw)[K6_ROWS]) {
#pragma unroll
  for (int q = 0; q < K6_ROWS; ++q) {
    const int dy = r - K6_R - q;
    if (dy < -K6_R || dy > K6_R) continue;
    const int ax = dx < 0 ? -dx : dx, ay = dy < 0 ? -dy : dy;
    float e = eaw_tap_exponent<VAR>(c[q], tg, ta, dx, dy, s_normal, nfloor,
                                    VAR ? eaw_log2_kw(ax) + eaw_log2_kw(ay) : 0.0f);
    if (!VAR) e += ta;
    const float w = eaw_ex2(e);
    acc_r[q] = __fmaf_rn(w, tc.x, acc_r[q]);
    acc_g[q] = __fmaf_rn(w, tc.y, acc_g[q]);
    acc_b[q] = __fmaf_rn(w, tc.z, acc_b[q]);
    tw[q] += w;
    if (VAR) acc_v[q] = __fmaf_rn(w * w, tc.w, acc_v[q]);
  }
}

// An output of a stage: the filtered colour where the centre is live and
// the weights sum to at least EPS, else the centre's clamped colour.
template <bool VAR>
__device__ __forceinline__ float4 k6_result(float4 cc, bool live, float acc_r, float acc_g,
                                            float acc_b, float acc_v, float tw) {
  if (!live || tw < EAW_EPS) return cc;
  const float inv = 1.0f / fmaxf(tw, EAW_EPS);
  return make_float4(acc_r * inv, acc_g * inv, acc_b * inv, VAR ? acc_v * inv * inv : 0.0f);
}

template <typename S, bool VAR>
__global__ void __launch_bounds__(K6_THREADS, K6_MIN_BLOCKS)
eaw_pair_kernel(const S* __restrict__ col, const S* __restrict__ geo, S* __restrict__ out,
                int height, int width, int stride_a, int stride_b, int tile_x, int tile_y,
                int tiles_x, float s_normal, float s_depth, float s_luma) {
  extern __shared__ float4 k6_smem[];
  const int nx = tile_x + 4 * stride_b, ny = tile_y + 4 * stride_b;
  float4* s_col = k6_smem;                                   // stage A: clamped colour
  float* s_aux = reinterpret_cast<float*>(s_col + nx * ny);  // stage A: luminance / validity
  const int x0 = (blockIdx.x % tiles_x) * tile_x, y0 = (blockIdx.x / tiles_x) * tile_y;
  const float nfloor = s_normal == 0.0f ? 1.0f : 0.0f;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // stage A over the region, origin (x0 - 2 stride_b, y0 - 2 stride_b)
  {
    const K6Pass p = k6_pass(stride_a, nx, ny);
    const int s = stride_a, rx0 = x0 - 2 * stride_b, ry0 = y0 - 2 * stride_b;
    for (int k = threadIdx.x; k < p.items; k += K6_THREADS) {
      int x, y;
      if (!k6_item(p, k, x, y)) continue;
      const int gx = rx0 + x, gy = ry0 + y;
      const bool col_in = (unsigned)gx < (unsigned)width;
      EawCentre c[K6_ROWS];
      float4 cc[K6_ROWS];
      bool here[K6_ROWS], live[K6_ROWS];
      bool any_live = false;
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q) {
        here[q] = y + q * s < ny;
        const bool in = here[q] && col_in && (unsigned)(gy + q * s) < (unsigned)height;
        const int idx = in ? (gy + q * s) * width + gx : 0;
        const float4 g = in ? eaw_load4(geo, idx) : zero;
        cc[q] = k6_clamped(in ? eaw_load4(col, idx) : zero);
        live[q] = in && g.w >= 1e-5f;
        any_live |= live[q];
        c[q] = k6_centre(g, cc[q], VAR ? eaw_lum(cc[q].x, cc[q].y, cc[q].z) : 0.0f, s, s_depth,
                         s_luma);
      }
      float acc_r[K6_ROWS], acc_g[K6_ROWS], acc_b[K6_ROWS], acc_v[K6_ROWS], tw[K6_ROWS];
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q) acc_r[q] = acc_g[q] = acc_b[q] = acc_v[q] = tw[q] = 0.0f;
      if (any_live) {
#pragma unroll
        for (int r = 0; r < K6_ROWS + 2 * K6_R; ++r) {
          const int ty = gy + s * (r - K6_R);
          const bool row_in = (unsigned)ty < (unsigned)height;
#pragma unroll
          for (int dx = -K6_R; dx <= K6_R; ++dx) {
            const int tx = gx + s * dx;
            const bool in = row_in && (unsigned)tx < (unsigned)width;
            const int idx = in ? ty * width + tx : 0;
            const float4 tg = in ? eaw_load4(geo, idx) : zero;
            const float4 tc = k6_clamped(in ? eaw_load4(col, idx) : zero);
            k6_tap<VAR>(c, r, dx, tg, tc, k6_aux<VAR>(tc, tg.w >= 1e-5f), s_normal, nfloor,
                        acc_r, acc_g, acc_b, acc_v, tw);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q) {
        if (!here[q]) continue;
        const float4 o = k6_clamped(
            k6_result<VAR>(cc[q], live[q], acc_r[q], acc_g[q], acc_b[q], acc_v[q], tw[q]));
        const int i = (y + q * s) * nx + x;
        s_col[i] = o;
        s_aux[i] = k6_aux<VAR>(o, live[q]);
      }
    }
  }
  __syncthreads();

  // stage B over the tile, its colour taps from the region
  {
    const K6Pass p = k6_pass(stride_b, tile_x, tile_y);
    const int s = stride_b;
    for (int k = threadIdx.x; k < p.items; k += K6_THREADS) {
      int x, y;
      if (!k6_item(p, k, x, y)) continue;
      const int gx = x0 + x, gy = y0 + y;  // image
      const int rx = x + 2 * s, ry = y + 2 * s;  // region
      EawCentre c[K6_ROWS];
      float4 cc[K6_ROWS];
      bool here[K6_ROWS], live[K6_ROWS];
      bool any_live = false;
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q) {
        here[q] = y + q * s < tile_y && gx < width && gy + q * s < height;
        const int i = (here[q] ? ry + q * s : ry) * nx + rx;
        const float4 g = here[q] ? eaw_load4(geo, (gy + q * s) * width + gx) : zero;
        cc[q] = s_col[i];
        live[q] = here[q] && g.w >= 1e-5f;
        any_live |= live[q];
        c[q] = k6_centre(g, cc[q], VAR ? s_aux[i] : 0.0f, s, s_depth, s_luma);
      }
      float acc_r[K6_ROWS], acc_g[K6_ROWS], acc_b[K6_ROWS], acc_v[K6_ROWS], tw[K6_ROWS];
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q) acc_r[q] = acc_g[q] = acc_b[q] = acc_v[q] = tw[q] = 0.0f;
      if (any_live) {
#pragma unroll
        for (int r = 0; r < K6_ROWS + 2 * K6_R; ++r) {
          const int tr = ry + s * (r - K6_R);
          if (tr >= ny) continue;  // only an output below the tile would tap it
          const int ty = gy + s * (r - K6_R);
          const bool row_in = (unsigned)ty < (unsigned)height;
#pragma unroll
          for (int dx = -K6_R; dx <= K6_R; ++dx) {
            const int tx = gx + s * dx;
            const bool in = row_in && (unsigned)tx < (unsigned)width;
            const float4 tg = in ? eaw_load4(geo, ty * width + tx) : zero;
            const int i = tr * nx + rx + s * dx;
            k6_tap<VAR>(c, r, dx, tg, s_col[i], s_aux[i], s_normal, nfloor, acc_r, acc_g, acc_b,
                        acc_v, tw);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < K6_ROWS; ++q) {
        if (!here[q]) continue;
        eaw_store4(out, (gy + q * s) * width + gx,
                   k6_result<VAR>(cc[q], live[q], acc_r[q], acc_g[q], acc_b[q], acc_v[q], tw[q]));
      }
    }
  }
}

template <typename S>
static const void* eaw_pair_fn(int use_variance) {
  return use_variance ? reinterpret_cast<const void*>(eaw_pair_kernel<S, true>)
                      : reinterpret_cast<const void*>(eaw_pair_kernel<S, false>);
}

// One launch of the plan pair_plan gives: `grid` blocks of K6_THREADS,
// tile_x x tile_y outputs a block, `tiles_x` tiles a row, `shared` dynamic
// bytes (above 48 KB, so the limit is raised first).
template <typename S>
static int launch_eaw_pair(const void* col, const void* geo, void* out, int height, int width,
                           int stride_a, int stride_b, int use_variance, float s_normal,
                           float s_depth, float s_luma, int grid, int tile_x, int tile_y,
                           int tiles_x, int shared, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (grid > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        eaw_pair_fn<S>(use_variance), cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    const S* c = static_cast<const S*>(col);
    const S* g = static_cast<const S*>(geo);
    S* o = static_cast<S*>(out);
    if (use_variance)
      eaw_pair_kernel<S, true><<<grid, K6_THREADS, shared, stream>>>(
          c, g, o, height, width, stride_a, stride_b, tile_x, tile_y, tiles_x, s_normal,
          s_depth, s_luma);
    else
      eaw_pair_kernel<S, false><<<grid, K6_THREADS, shared, stream>>>(
          c, g, o, height, width, stride_a, stride_b, tile_x, tile_y, tiles_x, s_normal,
          s_depth, s_luma);
  }
  return (int)cudaGetLastError();
}

extern "C" int eaw_pair(const void* col, const void* geo, void* out, int height, int width,
                        int stride_a, int stride_b, int use_variance, float s_normal,
                        float s_depth, float s_luma, int grid, int tile_x, int tile_y,
                        int tiles_x, int shared, int device, cudaStream_t stream) {
  return launch_eaw_pair<float>(col, geo, out, height, width, stride_a, stride_b, use_variance,
                                s_normal, s_depth, s_luma, grid, tile_x, tile_y, tiles_x, shared,
                                device, stream);
}

extern "C" int eaw_pair_bf16(const void* col, const void* geo, void* out, int height,
                             int width, int stride_a, int stride_b, int use_variance,
                             float s_normal, float s_depth, float s_luma, int grid, int tile_x,
                             int tile_y, int tiles_x, int shared, int device,
                             cudaStream_t stream) {
  return launch_eaw_pair<__nv_bfloat16>(col, geo, out, height, width, stride_a, stride_b,
                                        use_variance, s_normal, s_depth, s_luma, grid, tile_x,
                                        tile_y, tiles_x, shared, device, stream);
}

// K6's build on `device` with `shared` dynamic bytes a block: out[0]
// registers a thread, [1] local bytes a thread, [2] static shared bytes,
// [3] dynamic shared bytes, [4] resident blocks of K6_THREADS an SM, [5]
// the SMs.
extern "C" int eaw_pair_info(int bf16, int use_variance, int shared, int* out, int device) {
  cudaSetDevice(device);
  const void* fn = bf16 ? eaw_pair_fn<__nv_bfloat16>(use_variance) : eaw_pair_fn<float>(use_variance);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, K6_THREADS, shared);
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
