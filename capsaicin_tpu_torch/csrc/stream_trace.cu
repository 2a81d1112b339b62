// K10 stream_trace: closest-hit and any-hit ray queries by the stream
// traversal. A sub-packet of 128 rays culls every leaf-block box at once,
// sorts the blocks it hit nearest first, and each warp of the sub-packet
// streams that list for its 32 rays, testing each ray against the popped
// block's box and, where it passes, against the block's triangles.
//
// Replaces capsaicin_tpu/ops/stream.py:_stream_kernel, which runs a gang of
// 8 sub-packets (TPU sublanes) per grid step: it keeps the candidate
// blocks as a mask in VMEM and min-extracts the next one at every step,
// DMAs the blocks from HBM with double-buffered semaphores, and tests every
// ray of a sub-packet against every triangle of its block on [8, 128]
// tiles. Here a block of 128 threads is one sub-packet at a time, one
// thread a ray, and a warp streams on its own.
//
// Bound: operations. The cull is 86 float operations a box for every
// sub-packet with a live ray; each block a warp pops costs a slab test (22)
// for each of its rays still searching, and a triangle test (45) for each
// triangle of the block and each ray that passed its box. The popped
// blocks' 48-byte triangle slots come from L2 (the colonnade's 12.6 MB of
// slots fit in its 50 MB). What held the first design back on this card
// was latency, not either bound: 69 KB of shared memory a sub-packet (3
// blocks, 12 warps an SM), a block-wide barrier before every pop, and every
// ray testing every triangle of every popped block. This design:
// - Bounded shared memory. Each sub-packet's candidate list goes to a
//   tile of STREAM_TILE keys in shared memory, and past that to a scratch
//   of n_blocks keys a block in device memory (two lists: the merge
//   ping-pongs). Shared memory is a fixed 22.7 KB (the tile, a stage of
//   triangle slots a warp, the reductions), under the ceiling of
//   STREAM_SHARED_CEILING whatever n_blocks is, so n_blocks is limited by
//   device memory alone. With at most 64 registers a thread
//   (__launch_bounds__), 8 blocks of 128 threads (32 warps) fit an SM.
// - A persistent grid: as many blocks as are resident (the wrapper asks
//   the occupancy API, ops/stream.launch_plan). Each takes the next
//   sub-packet from an atomic counter, in `order` where one is given
//   (ops/stream.balance_order: the most candidates first).
// - Cull (stream_common.cuh): each box the sub-packet's bounds hit is
//   appended as one 64-bit key, the entry distance tn in order-preserving
//   bits (-0.0 as +0.0) then the block id; a warp ballot takes one shared
//   atomic per warp and 128 boxes.
// - Order: a list of at most STREAM_TILE keys is sorted in shared memory
//   (bitonic). A longer one is sorted in tiles of STREAM_TILE, which are
//   merged pairwise in device memory (merge path: each thread finds its
//   output range by a binary search, then merges it). The keys are unique,
//   so the order is exactly (tn, block id), the TPU kernel's pop order.
// - Stream, per warp, with no barrier: the warp's cap is the largest reach
//   of its 32 rays (min(t_best, tmax) of a live ray; for any-hit tmax of a
//   live ray without a hit), taken with shuffles after every block that
//   was tested. The warp stops at the first block whose tn exceeds it: the
//   cap never rises, so no later block could pass. The warp reads 32 keys
//   and their boxes at once, one a lane, and hands them round with
//   shuffles. Each ray slab-tests the popped block's box against its own
//   reach (ray_box, below) and skips the block's triangles when it misses.
//   Only if a ray passed does the warp copy the block's slots into its
//   stage in shared memory with cp.async, 32 triangles at a time, all
//   lanes' 16-byte copies in flight at once; this was measured faster than
//   loads of one address in every lane from L2 (PERF.md, the K10 A/B). Each passing ray
//   tests the slots in order with the Moller-Trumbore arithmetic of K7 and
//   of the plain version, hits accepted on tmin < t < t_best; the first
//   slot with id -1 ends a block (padding is at its end). An any-hit ray
//   stops at its first hit; a dead ray (tmax < tmin) counts as decided and
//   is reported as not hit. A closest-hit miss returns t = 1e30,
//   u = v = 0, prim = -1.
// Every ray meets the blocks it tests in the first design's order, and a
// block it skips holds no hit for it, so the results are those of the
// first design and of the plain version (ops/stream.stream_trace_plain,
// which counts this design's work: warps' pops, box tests, triangle tests).
// Built with --fmad=false, like every kernel here, so that the products and
// sums round as in the plain version.
#include <cuda_pipeline.h>

#include "stream_common.cuh"

#define STREAM_MAX_BLOCK_TRIS 128
#define STREAM_MISS_T 1e30f
#define STREAM_TILE 2048  // keys sorted in shared memory at once: 16 KB
#define STREAM_STAGE_TRIS 32  // triangle slots a warp stages at once: 1.5 KB
#define STREAM_MIN_CTAS 8  // blocks of 128 threads an SM: at most 64 registers
#define STREAM_SHARED_CEILING 24576  // K10's shared bytes a block, whatever n_blocks is
// The per-ray box test pads the block's box by STREAM_BOX_PAD times the
// largest magnitude of its corners' and the ray origin's coordinates. The
// slab arithmetic (two subtractions and a product an axis) rounds by at
// most a few ulps (2^-23 each) of those magnitudes, so the pad is 40 times
// its error: the padded test passes every ray whose exact path meets the
// box. Moller-Trumbore accepts hits up to a few ulps outside a triangle (an
// edge-grazing ray), which the pad covers too; a plain test of the box
// built from the vertices would reject some of those. In t, the pad widens
// each slab by at least 1e-5 of |t|, and t (the entry against the reach)
// rounds by a few ulps. Directions shorter than 1e-12 on an axis take the
// clamped inverse of stream_safe_inv; the slab they give still holds the
// ray's whole reach there (|t| >= 1e7 times the magnitudes). The pad only
// admits more blocks, so it costs work, never a result.
#define STREAM_BOX_PAD 1e-5f

static_assert(STREAM_TILE * 8 + STREAM_WARPS * (STREAM_NRED * 4 + STREAM_STAGE_TRIS * 48) + 16 <=
                  STREAM_SHARED_CEILING,
              "K10's shared memory is above its ceiling");

__device__ __forceinline__ unsigned int order_bits(float f) {
  const unsigned int u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The padded slab test of one ray against a block's box (see STREAM_BOX_PAD);
// `om` is the largest |origin| coordinate of the ray. The plain version
// (ops/stream._ray_box) does the same operations in the same order.
__device__ __forceinline__ bool ray_box(const StreamRay& r, float om, float lx, float ly,
                                        float lz, float hx, float hy, float hz, float tmin,
                                        float reach) {
  const float m = fmaxf(fmaxf(fmaxf(fabsf(lx), fabsf(ly)), fmaxf(fabsf(lz), fabsf(hx))),
                        fmaxf(fabsf(hy), fabsf(hz)));
  const float pad = STREAM_BOX_PAD * (m + om);
  const float lo[3] = {lx, ly, lz}, hi[3] = {hx, hy, hz};
  float tn = 0.0f, tf = 0.0f;
  for (int a = 0; a < 3; ++a) {
    const float t0 = ((lo[a] - pad) - r.o[a]) * r.inv[a];
    const float t1 = ((hi[a] + pad) - r.o[a]) * r.inv[a];
    tn = a == 0 ? fminf(t0, t1) : fmaxf(tn, fminf(t0, t1));
    tf = a == 0 ? fmaxf(t0, t1) : fminf(tf, fmaxf(t0, t1));
  }
  return tn <= tf && tf >= tmin && tn <= reach;
}

// Bitonic sort of tile[0, n) in shared memory, the tail up to a power of
// two padded with the largest key. Every thread calls it; it synchronises.
__device__ void sort_tile(unsigned long long* tile, int n) {
  int m = 1;
  while (m < n) m <<= 1;
  for (int k = n + threadIdx.x; k < m; k += STREAM_LANE) tile[k] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= m; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < m / 2; t += STREAM_LANE) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = tile[lo], c = tile[hi];
        if ((a > c) == ((lo & size) == 0)) {
          tile[lo] = c;
          tile[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// One merge pass in device memory: the sorted runs of w keys of src[0,
// count), pairwise, into dst. Each thread merges a contiguous range of a
// pair's output, found by a binary search along the merge path (the keys
// are unique). The caller synchronises after it.
__device__ void merge_runs(const unsigned long long* src, unsigned long long* dst, int count,
                           int w) {
  for (int base = 0; base < count; base += 2 * w) {
    const unsigned long long* a = src + base;
    const int na = min(w, count - base);
    const unsigned long long* b = a + na;
    const int nb = min(w, count - base - na);
    const int total = na + nb;
    const int chunk = (total + STREAM_LANE - 1) / STREAM_LANE;
    const int d0 = threadIdx.x * chunk;
    const int d1 = min(d0 + chunk, total);
    if (d0 >= total) continue;
    int lo = max(0, d0 - nb), hi = min(d0, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a[mid] < b[d0 - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    int i = lo, j = d0 - lo;
    unsigned long long va = i < na ? a[i] : ~0ull, vb = j < nb ? b[j] : ~0ull;
    for (int d = d0; d < d1; ++d) {
      if (va < vb) {
        dst[base + d] = va;
        va = ++i < na ? a[i] : ~0ull;
      } else {
        dst[base + d] = vb;
        vb = ++j < nb ? b[j] : ~0ull;
      }
    }
  }
}

template <bool ANY>
__global__ void __launch_bounds__(STREAM_LANE, STREAM_MIN_CTAS) stream_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
    const float* __restrict__ tmax, const float4* __restrict__ boxes,
    const float4* __restrict__ tris, const int* __restrict__ order, int n_rays, int n_blocks,
    int block_tris, unsigned long long* __restrict__ scratch, unsigned int* __restrict__ next,
    float* __restrict__ t_out, float* __restrict__ u_out, float* __restrict__ v_out,
    int* __restrict__ prim_out, unsigned char* __restrict__ hit_out) {
  __shared__ unsigned long long tile[STREAM_TILE];
  __shared__ float red[STREAM_WARPS * STREAM_NRED];
  __shared__ int n_cand, sp_next;
  __shared__ __align__(16) float4 stage_all[STREAM_WARPS][3 * STREAM_STAGE_TRIS];

  const int n_sub = (n_rays + STREAM_LANE - 1) / STREAM_LANE;
  unsigned long long* list = scratch + (size_t)blockIdx.x * 2 * n_blocks;
  unsigned long long* alt = list + n_blocks;
  const int lane = threadIdx.x & 31;
  for (;;) {
    if (threadIdx.x == 0) {
      sp_next = (int)atomicAdd(next, 1u);
      n_cand = 0;
    }
    __syncthreads();
    const int x = sp_next;
    if (x >= n_sub) break;  // the same in every thread
    const int sp = order ? order[x] : x;
    if ((unsigned int)sp < (unsigned int)n_sub) {  // the same in every thread
      const StreamRay r = load_stream_ray(origins, dirs, tmin, tmax, n_rays, sp);
      const SubPacketBounds b = sub_packet_bounds(r, tmin, red);  // synchronises

      // cull: every box, the hits appended to the list (its first
      // STREAM_TILE keys in shared memory)
      if (b.any_live) {
        for (int k0 = 0; k0 < n_blocks; k0 += STREAM_LANE) {
          const int k = k0 + threadIdx.x;
          float tn;
          const bool hit =
              k < n_blocks && box_candidate(b, __ldg(boxes + 2 * k), __ldg(boxes + 2 * k + 1), tn);
          const unsigned int ballot = __ballot_sync(0xffffffffu, hit);
          if (ballot == 0u) continue;
          int at = 0;
          if (lane == __ffs(ballot) - 1) at = atomicAdd(&n_cand, __popc(ballot));
          at = __shfl_sync(0xffffffffu, at, __ffs(ballot) - 1) +
               __popc(ballot & ((1u << lane) - 1u));
          if (hit) {
            const unsigned long long key = ((unsigned long long)order_bits(tn) << 32) | (unsigned int)k;
            if (at < STREAM_TILE) tile[at] = key;
            else list[at] = key;
          }
        }
      }
      __syncthreads();
      const int count = n_cand;

      // order
      const unsigned long long* keys = tile;
      if (count <= STREAM_TILE) {
        sort_tile(tile, count);
      } else {
        for (int r0 = 0; r0 < count; r0 += STREAM_TILE) {
          const int n = min(STREAM_TILE, count - r0);
          if (r0 > 0) {
            for (int k = threadIdx.x; k < n; k += STREAM_LANE) tile[k] = list[r0 + k];
          }
          sort_tile(tile, n);
          for (int k = threadIdx.x; k < n; k += STREAM_LANE) list[r0 + k] = tile[k];
          __syncthreads();
        }
        unsigned long long *src = list, *dst = alt;
        for (int w = STREAM_TILE; w < count; w *= 2) {
          merge_runs(src, dst, count, w);
          __syncthreads();
          unsigned long long* t = src;
          src = dst;
          dst = t;
        }
        keys = src;
      }

      // stream, each warp on its own
      float t_best = r.tmax, bu = 0.0f, bv = 0.0f;
      int prim = (ANY && !r.live) ? 0 : -1;
      const float om = fmaxf(fmaxf(fabsf(r.o[0]), fabsf(r.o[1])), fabsf(r.o[2]));
      // the lane's reach: a live ray's t_best (it starts at tmax), for
      // any-hit the tmax of a live ray without a hit (prim < 0 only there)
      float cap = warp_max(ANY ? (prim < 0 ? r.tmax : -STREAM_BIG)
                               : (r.live ? t_best : -STREAM_BIG));
      for (int k0 = 0; k0 < count; k0 += 32) {
        // 32 keys and their boxes, one a lane
        const int kk = k0 + lane;
        unsigned int kt = 0xffffffffu;
        int kb = 0;
        float4 blo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), bhi = blo;
        if (kk < count) {
          const unsigned long long key = keys[kk];
          kt = (unsigned int)(key >> 32);
          kb = (int)(unsigned int)(key & 0xffffffffu);
          blo = __ldg(boxes + 2 * kb);
          bhi = __ldg(boxes + 2 * kb + 1);
        }
        const int n_here = min(32, count - k0);
        int j = 0;
        for (; j < n_here; ++j) {
          if (from_order_bits(__shfl_sync(0xffffffffu, kt, j)) > cap) break;  // warp-uniform
          const int blk = __shfl_sync(0xffffffffu, kb, j);
          const float lx = __shfl_sync(0xffffffffu, blo.x, j);
          const float ly = __shfl_sync(0xffffffffu, blo.y, j);
          const float lz = __shfl_sync(0xffffffffu, blo.z, j);
          const float hx = __shfl_sync(0xffffffffu, bhi.x, j);
          const float hy = __shfl_sync(0xffffffffu, bhi.y, j);
          const float hz = __shfl_sync(0xffffffffu, bhi.z, j);
          bool go = (ANY ? prim < 0 : r.live) &&
                    ray_box(r, om, lx, ly, lz, hx, hy, hz, tmin, ANY ? r.tmax : t_best);
          if (!__any_sync(0xffffffffu, go)) continue;
          const float4* src = tris + (size_t)blk * 3 * block_tris;
          // the block's slots, STREAM_STAGE_TRIS at a time, copied into the
          // warp's stage with cp.async (16 bytes a lane, all in flight at
          // once), then read by every lane from shared memory
          float4* stage = stage_all[threadIdx.x >> 5];
          bool more = true;
          for (int c0 = 0; c0 < block_tris && more; c0 += STREAM_STAGE_TRIS) {
            const int nt = min(STREAM_STAGE_TRIS, block_tris - c0);
            __syncwarp();  // the warp's reads of the last stage are done
            for (int x = lane; x < 3 * nt; x += 32)
              __pipeline_memcpy_async(stage + x, src + 3 * c0 + x, 16);
            __pipeline_commit();
            __pipeline_wait_prior(0);
            __syncwarp();
            const float4* s = stage;
            for (int q = 0; q < nt; ++q, s += 3) {
              const float4 a = s[0];
              const int tid = __float_as_int(a.w);
              if (tid < 0) {  // padding: the same slot in every lane
                more = false;
                break;
              }
              if (go) {
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
                  if (ANY) go = false;
                }
              }
              if (ANY && !__any_sync(0xffffffffu, go)) {
                more = false;
                break;
              }
            }
          }
          cap = warp_max(ANY ? (prim < 0 ? r.tmax : -STREAM_BIG)
                             : (r.live ? t_best : -STREAM_BIG));
        }
        if (j < n_here) break;  // the warp's cap stopped it
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
    __syncthreads();  // the list, the tile and sp_next are free again
  }
}

// K10's attributes and residency on `device`, for the launch plan and the
// smoke script: out = {registers a thread, static shared bytes, local
// (spilled) bytes a thread, resident blocks of 128 threads an SM, SMs}.
extern "C" int stream_trace_info(int any_hit, int* out, int device) {
  cudaError_t err = cudaSetDevice(device);
  cudaFuncAttributes attr;
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = any_hit ? cudaFuncGetAttributes(&attr, stream_trace_kernel<true>)
                  : cudaFuncGetAttributes(&attr, stream_trace_kernel<false>);
  if (err == cudaSuccess)
    err = any_hit ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, stream_trace_kernel<true>, STREAM_LANE, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, stream_trace_kernel<false>, STREAM_LANE, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = (int)attr.localSizeBytes;
  out[3] = per_sm;
  out[4] = sms;
  return 0;
}

// `grid` blocks (ops/stream.launch_plan); `scratch` holds 2 * grid *
// n_blocks keys and, after them, the sub-packet counter, which is zeroed
// here on the stream before the launch.
extern "C" int stream_trace(const float* origins, const float* dirs, float tmin,
                            const float* tmax, const float* boxes, const float* tris,
                            const int* order, int n_rays, int n_blocks, int block_tris,
                            int any_hit, int grid, void* scratch, float* t_out, float* u_out,
                            float* v_out, int* prim_out, unsigned char* hit_out, int device,
                            cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_blocks < 1 || block_tris < 1 || block_tris > STREAM_MAX_BLOCK_TRIS || grid < 1)
    return (int)cudaErrorInvalidValue;
  unsigned long long* keys = static_cast<unsigned long long*>(scratch);
  unsigned int* next = reinterpret_cast<unsigned int*>(keys + (size_t)2 * grid * n_blocks);
  cudaError_t err = cudaMemsetAsync(next, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess || n_rays <= 0) return (int)err;
  const float4* b4 = reinterpret_cast<const float4*>(boxes);
  const float4* t4 = reinterpret_cast<const float4*>(tris);
  if (any_hit)
    stream_trace_kernel<true><<<grid, STREAM_LANE, 0, stream>>>(
        origins, dirs, tmin, tmax, b4, t4, order, n_rays, n_blocks, block_tris, keys, next,
        t_out, u_out, v_out, prim_out, hit_out);
  else
    stream_trace_kernel<false><<<grid, STREAM_LANE, 0, stream>>>(
        origins, dirs, tmin, tmax, b4, t4, order, n_rays, n_blocks, block_tris, keys, next,
        t_out, u_out, v_out, prim_out, hit_out);
  return (int)cudaGetLastError();
}
