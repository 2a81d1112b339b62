// K10 stream_trace: closest-hit and any-hit ray queries by the stream
// traversal. A sub-packet of 128 rays culls every leaf-block box at once,
// then streams the blocks it hit nearest first and tests each block's
// triangles against its rays.
//
// Replaces capsaicin_tpu/ops/stream.py:_stream_kernel, which runs a gang of
// 8 sub-packets (TPU sublanes) per grid step: it keeps the candidate
// blocks as a mask in VMEM and min-extracts the next one at every step,
// DMAs the blocks from HBM with double-buffered semaphores, and tests each
// sub-packet's block on [8, 128] tiles. Here one block of 128 threads is
// one sub-packet, one thread a ray. Block x takes sub-packet order[x] where
// an order is given (ops/stream.balance_order: the most candidates first,
// so the longest sub-packets start first), else sub-packet x.
//
// Bound: operations. The cull is 86 float operations a box for every
// sub-packet with a live ray, and each popped block costs a triangle test
// of about 45 for each of its triangles and each live ray (for any-hit,
// each live ray not yet hit); the popped blocks' 48-byte triangle slots
// come from L2 or HBM once per sub-packet that pops them. Which dominates
// depends on the rays: coherent primary and shadow rays pop a few blocks,
// scattered bounce rays hundreds (chip_smoke.py counts them).
//
// Design:
// - Cull (stream_common.cuh): each block the sub-packet's bounds hit is
//   appended to a list in shared memory with a shared atomic counter, as
//   one 64-bit key: the entry distance tn in order-preserving bits (-0.0
//   as +0.0), then the block id. The list holds n_blocks keys (64 KB at
//   8192 blocks; the wrapper opts in to more than 48 KB and raises where
//   one block cannot hold them).
// - Order: one bitonic sort of the list in shared memory, over its count
//   rounded up to a power of two, gives the (tn, block id) order that the
//   TPU kernel extracts one step at a time.
// - Stream: before each pop, a block reduction takes the cap (the largest
//   min(t_best, tmax) of the live rays; for any-hit the largest tmax of the
//   live rays without a hit), and the stream stops at the first block whose
//   tn exceeds it: the cap never rises, so no later block could pass. A
//   block's triangle slots are staged in shared memory, two buffers: each
//   thread loads its share of the next block into registers before testing
//   the current one, and stores it after. Each thread tests its ray against
//   the staged slots in slot order with the Moller-Trumbore arithmetic of
//   K7 and of the plain version, hits accepted on tmin < t < t_best; the
//   first slot with id -1 ends a block (padding is at its end). An any-hit
//   ray stops testing at its first hit; a dead ray (tmax < tmin) counts as
//   decided and is reported as not hit. A closest-hit miss returns t = 1e30,
//   u = v = 0, prim = -1.
// Built with --fmad=false, like every kernel here, so that the products and
// sums round as in the plain version.
#include "stream_common.cuh"

#define STREAM_MAX_BLOCK_TRIS 128
// float4s of a staged block that one thread carries: 3 a slot
#define STREAM_PREFETCH ((3 * STREAM_MAX_BLOCK_TRIS + STREAM_LANE - 1) / STREAM_LANE)
#define STREAM_MISS_T 1e30f

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The largest x of the block's threads; `buf` is STREAM_WARPS floats of
// shared memory that no thread reads again before the next barrier.
__device__ __forceinline__ float block_max(float x, float* buf) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x / 32] = x;
  __syncthreads();
  float m = buf[0];
  for (int w = 1; w < STREAM_WARPS; ++w) m = fmaxf(m, buf[w]);
  return m;
}

template <bool ANY>
__global__ void __launch_bounds__(STREAM_LANE) stream_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
    const float* __restrict__ tmax, const float4* __restrict__ boxes,
    const float4* __restrict__ tris, const int* __restrict__ order, int n_rays, int n_blocks,
    int block_tris, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ prim_out, unsigned char* __restrict__ hit_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  float4* stage = reinterpret_cast<float4*>(smem + (((size_t)n_blocks * 8 + 15) & ~(size_t)15));
  __shared__ float red[STREAM_WARPS * STREAM_NRED];
  __shared__ float cap_red[2][STREAM_WARPS];
  __shared__ int n_cand;

  const int sp = order ? order[blockIdx.x] : (int)blockIdx.x;
  if ((unsigned int)sp >= gridDim.x) return;  // not a sub-packet; the same in every thread
  const StreamRay r = load_stream_ray(origins, dirs, tmin, tmax, n_rays, sp);
  if (threadIdx.x == 0) n_cand = 0;
  const SubPacketBounds b = sub_packet_bounds(r, tmin, red);  // synchronises

  // cull: every box, the hits appended to the list
  if (b.any_live) {
    for (int k = threadIdx.x; k < n_blocks; k += STREAM_LANE) {
      float tn;
      if (box_candidate(b, __ldg(boxes + 2 * k), __ldg(boxes + 2 * k + 1), tn)) {
        const int at = atomicAdd(&n_cand, 1);
        keys[at] = ((unsigned long long)order_bits(tn) << 32) | (unsigned int)k;
      }
    }
  }
  __syncthreads();
  const int count = n_cand;

  // order: bitonic sort of keys[0, m), the tail past count padded with the
  // largest key
  int m = 1;
  while (m < count) m <<= 1;
  for (int k = count + threadIdx.x; k < m; k += STREAM_LANE) keys[k] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < m / 2; t += STREAM_LANE) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], c = keys[hi];
        if ((a > c) == ((lo & size) == 0)) {
          keys[lo] = c;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }

  // stream
  float t_best = r.tmax, bu = 0.0f, bv = 0.0f;
  int prim = (ANY && !r.live) ? 0 : -1;
  const int n_vec = 3 * block_tris;
  float4 pre[STREAM_PREFETCH];
  auto fetch = [&](int k) {
    const float4* src = tris + (size_t)(unsigned int)(keys[k] & 0xffffffffu) * n_vec;
    for (int j = 0; j < STREAM_PREFETCH; ++j) {
      const int x = threadIdx.x + j * STREAM_LANE;
      if (x < n_vec) pre[j] = __ldg(src + x);
    }
  };
  auto store = [&](int buf) {
    float4* dst = stage + buf * n_vec;
    for (int j = 0; j < STREAM_PREFETCH; ++j) {
      const int x = threadIdx.x + j * STREAM_LANE;
      if (x < n_vec) dst[x] = pre[j];
    }
  };
  if (count > 0) {
    fetch(0);
    store(0);  // the first cap reduction's barrier orders it before the reads
  }
  for (int k = 0; k < count; ++k) {
    const float c = ANY ? ((r.live && prim < 0) ? r.tmax : -STREAM_BIG)
                        : (r.live ? fminf(t_best, r.tmax) : -STREAM_BIG);
    const float cap = block_max(c, cap_red[k & 1]);  // synchronises
    if (from_order_bits((unsigned int)(keys[k] >> 32)) > cap) break;  // the same in every thread
    if (k + 1 < count) fetch(k + 1);  // in flight during the tests below
    const float4* s = stage + (k & 1) * n_vec;
    if (!ANY || prim < 0) {
      for (int j = 0; j < block_tris; ++j, s += 3) {
        const float4 a = s[0];
        const int tid = __float_as_int(a.w);
        if (tid < 0) break;
        const float4 e1 = s[1], e2 = s[2];
        const float px = r.d[1] * e2.z - r.d[2] * e2.y;
        const float py = r.d[2] * e2.x - r.d[0] * e2.z;
        const float pz = r.d[0] * e2.y - r.d[1] * e2.x;
        const float det = e1.x * px + e1.y * py + e1.z * pz;
        const bool det_ok = fabsf(det) > 1e-12f;
        const float inv_det = det_ok ? 1.0f / det : 0.0f;
        const float tvx = r.o[0] - a.x, tvy = r.o[1] - a.y, tvz = r.o[2] - a.z;
        const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
        const float qx = tvy * e1.z - tvz * e1.y;
        const float qy = tvz * e1.x - tvx * e1.z;
        const float qz = tvx * e1.y - tvy * e1.x;
        const float vv = (r.d[0] * qx + r.d[1] * qy + r.d[2] * qz) * inv_det;
        const float tt = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
        if (det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin &&
            tt < t_best) {
          t_best = tt;
          bu = uu;
          bv = vv;
          prim = tid;
          if (ANY) break;
        }
      }
    }
    if (k + 1 < count) store((k + 1) & 1);
  }

  if (r.in) {
    const int i = sp * STREAM_LANE + threadIdx.x;
    if (ANY) {
      hit_out[i] = (prim >= 0 && r.live) ? 1 : 0;
    } else {
      t_out[i] = prim < 0 ? STREAM_MISS_T : t_best;
      u_out[i] = bu;
      v_out[i] = bv;
      prim_out[i] = prim;
    }
  }
}

extern "C" int stream_trace(const float* origins, const float* dirs, float tmin,
                            const float* tmax, const float* boxes, const float* tris,
                            const int* order, int n_rays, int n_blocks, int block_tris,
                            int any_hit, float* t_out, float* u_out, float* v_out, int* prim_out,
                            unsigned char* hit_out, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  // the sort's padding to a power of two stays inside the n_blocks keys
  if (n_blocks < 2 || (n_blocks & (n_blocks - 1)) || block_tris < 1 ||
      block_tris > STREAM_MAX_BLOCK_TRIS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (((size_t)n_blocks * 8 + 15) & ~(size_t)15) +
                      (size_t)2 * 3 * block_tris * sizeof(float4);
  const int grid = (n_rays + STREAM_LANE - 1) / STREAM_LANE;
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  cudaError_t err;
  if (any_hit) {
    err = cudaFuncSetAttribute(stream_trace_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && n_rays > 0)
      stream_trace_kernel<true><<<grid, STREAM_LANE, smem, stream>>>(
          origins, dirs, tmin, tmax, b4, t4, order, n_rays, n_blocks, block_tris, t_out, u_out,
          v_out, prim_out, hit_out);
  } else {
    err = cudaFuncSetAttribute(stream_trace_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && n_rays > 0)
      stream_trace_kernel<false><<<grid, STREAM_LANE, smem, stream>>>(
          origins, dirs, tmin, tmax, b4, t4, order, n_rays, n_blocks, block_tris, t_out, u_out,
          v_out, prim_out, hit_out);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
