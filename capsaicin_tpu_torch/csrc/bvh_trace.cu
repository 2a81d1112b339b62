// K7 bvh_trace: closest-hit and any-hit ray queries against a BVH of any
// size, by an ordered stack walk of four-wide nodes collapsed from the
// binary median tree.
//
// Replaces capsaicin_tpu/ops/pallas_traverse.py:_traverse_kernel, which
// walks the tree with one node pointer for a whole 1024-ray packet
// (descending where any ray hits a box) because per-lane gathers are slow
// on a TPU. A GPU thread can follow its own ray, so here every ray has its
// own walk and its own stack.
//
// Bound: neither of the card's peaks. The work depends on the rays: the
// binary near-first walk (ops/traverse.py, ordered_walk) does tens to a few
// hundred box tests and tens of triangle tests per ray on the colonnade's
// 1080p rays, which at 67 TFLOP/s is a bound of a fraction of a
// millisecond against the milliseconds measured. Measured on the H100
// (PERF.md, K7's redesign), the walk is bound by the instructions it
// issues: a record of half the bytes (float16 boxes) but a third more
// instructions was slower, and so were a smaller stack in shared memory
// (more L1) and fewer resident warps; so the design cuts instructions a
// ray and idle lanes.
//
// Design:
// - Four-wide records (ops/bvh.py, pack_wide_nodes): one 128-byte record
//   of a binary node at even depth holds its four grandchildren's boxes in
//   SoA form, read as seven 16-byte loads issued together, and a step
//   tests all four. The walk takes half the steps of the binary one (74
//   records a primary ray against 149 pair records).
// - One copy of the records per direction-sign octant
//   (pack_octant_records), each record's slots stored in the order a ray
//   of that octant visits them (near pair first, near child first in each
//   pair, by the three pair codes), with their children: a step reads its
//   ray's copy and spends no instruction on ordering.
// - The binary walk's leaf order, so its results bit for bit: the passing
//   slots after the first are pushed, last first, with their entry
//   distance, and a popped entry is skipped when that distance is beyond
//   the best hit. A grandchild's box lies inside its parent's, and the slab
//   test is monotone in the box's planes, so a slot passes exactly when the
//   binary walk would have passed its parent and then it: the same leaves
//   are tested in the same order against the same best hit.
// - Leaves held (Aila and Laine's speculative traversal): a lane that
//   reaches a leaf while it holds none holds it and walks on, and the
//   warp tests leaves once every walking lane holds one (or a lane reaches
//   a second leaf or the end), so a warp's lanes test leaves together.
//   Leaves are still tested in the walk's order, each only while its entry
//   distance is no farther than the best hit; a lane walks some records
//   against a best hit not yet updated, which adds box tests, not leaves.
// - No stack in local memory: each thread's stack is a column of the
//   block's dynamic shared memory (entry e of thread t at e * BLOCK + t, so
//   a warp's 32 entries fall in distinct banks), sized by the caller from
//   the tree's depth: 3 entries a four-wide level, 1 for a final two-wide
//   one.
// - Persistent warps (Aila and Laine, HPG 2009): the grid is the resident
//   blocks (occupancy API) and each warp takes 32 rays at a time from an
//   atomic counter that the wrapper zeroes, so a warp whose rays end early
//   takes more and no block's slowest ray holds an SM. Rays in pixel order
//   may be taken as 8x4 pixel tiles (tile_w), whose walks share more nodes
//   than a 32x1 strip's.
// Leaves of leaf_size triangle slots, three float4s each with the id in a
// spare lane; the first slot with id -1 ends the leaf. The slab test,
// safe_inv and the Moller-Trumbore arithmetic are those of ops/traverse.py
// and K1, hits accepted on the strict tmin < t < t_best (t_best starts at
// tmax). An any-hit ray returns at its first accepted hit; a dead ray
// (tmax < tmin) does no work. Built with --fmad=false, like every kernel
// here, so that hits on triangle edges agree with the plain version.
//
// Counting build (COUNT, taken while a profiler records): each thread adds
// up the rays it walks (live ones), the child boxes it tests (the slots
// that hold triangles, of every record it fetches) and the triangles it
// tests (Moller-Trumbore tests of real slots); at its exit each warp adds
// its sums into three int64 words with one atomicAdd each. It changes no
// result. The box tests of a lane include those it makes while it holds a
// leaf, so they depend on the warp's other rays; the rays and triangle
// tests do not. The plain build (COUNT false) is the kernel as it was.
#include <climits>
#include <cuda_runtime.h>

#define BVH_BLOCK 128
#define BVH_DONE INT_MIN        // the walk is over (leaf refs are ~leaf >= -2^30)
#define BVH_EMPTY (INT_MIN + 1)  // a slot with no triangle (ops/bvh.py, EMPTY_SLOT)
#define BVH_MAX_STACK 45  // entries a thread: depth 30 (ops/bvh.py, MAX_DEPTH)

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) < 1e-12f ? (d < 0.0f ? -1e12f : 1e12f) : 1.0f / d;
}

// Slab test of the box lo..hi; t_near is written for the stack. The
// result is the plain version's test, t_near <= t_far && t_far >= tmin &&
// t_near <= t_best, in one comparison: the same whenever tmin <= t_best,
// which holds for a live ray (accepted hits lie above tmin), and no
// operand is NaN (the products are finite or infinite).
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly, float lz, float hx,
                                     float hy, float hz, float t_best, float& t_near) {
  const float tx0 = (lx - r.ox) * r.ix, tx1 = (hx - r.ox) * r.ix;
  const float ty0 = (ly - r.oy) * r.iy, ty1 = (hy - r.oy) * r.iy;
  const float tz0 = (lz - r.oz) * r.iz, tz1 = (hz - r.oz) * r.iz;
  t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return fmaxf(t_near, r.tmin) <= fminf(t_far, t_best);
}

// A thread's work, summed by the counting build only.
struct Work {
  unsigned rays, boxes, tris;
};

// The triangles of one leaf, in slot order. Returns true on an accepted
// hit when ANY is set (the caller stops there).
template <bool ANY, bool COUNT>
__device__ __forceinline__ bool leaf_test(const float4* __restrict__ tris, int leaf,
                                          int leaf_size, const Ray& r, float& t_best,
                                          float& bu, float& bv, int& prim, Work& w) {
  const float4* tr = tris + 3 * (size_t)leaf * leaf_size;
  for (int j = 0; j < leaf_size; ++j, tr += 3) {
    const float4 a = __ldg(tr);
    const int tid = __float_as_int(a.w);
    if (tid < 0) break;
    if (COUNT) ++w.tris;
    const float4 e1 = __ldg(tr + 1), e2 = __ldg(tr + 2);
    const float px = r.dy * e2.z - r.dz * e2.y;
    const float py = r.dz * e2.x - r.dx * e2.z;
    const float pz = r.dx * e2.y - r.dy * e2.x;
    const float det = e1.x * px + e1.y * py + e1.z * pz;
    const bool det_ok = fabsf(det) > 1e-12f;
    const float inv_det = det_ok ? 1.0f / det : 0.0f;
    const float tvx = r.ox - a.x, tvy = r.oy - a.y, tvz = r.oz - a.z;
    const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
    const float qx = tvy * e1.z - tvz * e1.y;
    const float qy = tvz * e1.x - tvx * e1.z;
    const float qz = tvx * e1.y - tvy * e1.x;
    const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float tt = (e2.x * qx + e2.y * qy + e2.z * qz) * inv_det;
    if (det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > r.tmin && tt < t_best) {
      t_best = tt;
      bu = uu;
      bv = vv;
      prim = tid;
      if (ANY) return true;
    }
  }
  return false;
}

extern __shared__ int2 bvh_stack[];

// A thread's stack of (node, entry distance): a column of the block's
// dynamic shared memory, entry e at e * BVH_BLOCK.
struct Stack {
  int2* sh;  // bvh_stack + threadIdx.x
  int sp;

  __device__ __forceinline__ void push(int ref, float t_near) {
    sh[sp++ * BVH_BLOCK] = make_int2(ref, __float_as_int(t_near));
  }

  // The next entry whose box is still no farther than the best hit (and
  // its entry distance in t_near), or BVH_DONE.
  __device__ __forceinline__ int pop(float t_best, float& t_near) {
    while (sp > 0) {
      const int2 e = sh[--sp * BVH_BLOCK];
      t_near = __int_as_float(e.y);
      if (t_near <= t_best) return e.x;
    }
    return BVH_DONE;
  }
};

// The four slots of record `cur` of the ray's octant copy, in the binary
// walk's order, tested against the ray: passed (h), entry distance (t)
// and child (ref: a record, ~leaf, or BVH_EMPTY, which is not tested).
struct Slots {
  bool h0, h1, h2, h3;
  float t0, t1, t2, t3;
  int r0, r1, r2, r3;
};

__device__ __forceinline__ void test_slots(const float4* __restrict__ wide, int cur,
                                           const Ray& r, float t_best, Slots& s) {
  const float4* rec = wide + 8 * (size_t)cur;
  const float4 lx = __ldg(rec), ly = __ldg(rec + 1), lz = __ldg(rec + 2);
  const float4 hx = __ldg(rec + 3), hy = __ldg(rec + 4), hz = __ldg(rec + 5);
  const int4 ref = __ldg(reinterpret_cast<const int4*>(rec + 6));
  s.t0 = s.t1 = s.t2 = s.t3 = 0.0f;
  s.h0 = ref.x != BVH_EMPTY && slab(r, lx.x, ly.x, lz.x, hx.x, hy.x, hz.x, t_best, s.t0);
  s.h1 = ref.y != BVH_EMPTY && slab(r, lx.y, ly.y, lz.y, hx.y, hy.y, hz.y, t_best, s.t1);
  s.h2 = ref.z != BVH_EMPTY && slab(r, lx.z, ly.z, lz.z, hx.z, hy.z, hz.z, t_best, s.t2);
  s.h3 = ref.w != BVH_EMPTY && slab(r, lx.w, ly.w, lz.w, hx.w, hy.w, hz.w, t_best, s.t3);
  s.r0 = ref.x;
  s.r1 = ref.y;
  s.r2 = ref.z;
  s.r3 = ref.w;
}

template <bool ANY, bool COUNT>
__device__ __forceinline__ void trace_ray(int i, const float* __restrict__ origins,
                                          const float* __restrict__ dirs, float tmin,
                                          const float* __restrict__ tmax,
                                          const float4* __restrict__ wide, int n_wide,
                                          const float4* __restrict__ tris, int leaf_size,
                                          Stack& stack, float* __restrict__ t_out,
                                          float* __restrict__ u_out, float* __restrict__ v_out,
                                          int* __restrict__ prim_out,
                                          unsigned char* __restrict__ hit_out, Work& w) {
  Ray r;
  r.ox = origins[3 * i];
  r.oy = origins[3 * i + 1];
  r.oz = origins[3 * i + 2];
  r.dx = dirs[3 * i];
  r.dy = dirs[3 * i + 1];
  r.dz = dirs[3 * i + 2];
  r.tmin = tmin;
  float t_best = tmax[i];
  float bu = 0.0f, bv = 0.0f;
  int prim = -1;

  if (t_best >= tmin) {
    if (COUNT) ++w.rays;
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    // the records of the ray's direction-sign octant
    const int octant = (r.dx > 0.0f) | (r.dy > 0.0f) << 1 | (r.dz > 0.0f) << 2;
    const float4* wide_o = wide + (size_t)octant * n_wide * 8;
    stack.sp = 0;
    // cur: the next record or leaf (t_cur its entry distance); held: a
    // leaf the walk went past (Aila and Laine's speculative traversal), so
    // that a warp's lanes test leaves together. Leaves are still tested in
    // the walk's order, each only while its entry distance is no farther
    // than the best hit, so the results are those of the ordered walk.
    int cur = 0, held = BVH_DONE;  // the root's record
    float t_cur = 0.0f, t_held = 0.0f;
    while (true) {
      while (cur >= 0 || (cur != BVH_DONE && held == BVH_DONE)) {
        if (cur < 0) {  // a leaf, and none held: hold it and walk on
          held = cur;
          t_held = t_cur;
          cur = stack.pop(t_best, t_cur);
        } else {  // a record: test its slots, go to the first passed
          Slots sl;
          test_slots(wide_o, cur, r, t_best, sl);
          if (COUNT)
            w.boxes += (sl.r0 != BVH_EMPTY) + (sl.r1 != BVH_EMPTY) + (sl.r2 != BVH_EMPTY) +
                       (sl.r3 != BVH_EMPTY);
          // push the passed slots after the first, last first
          cur = BVH_DONE;
#define BVH_VISIT(h, rr, tt)                                               \
  if (h) {                                                                 \
    if (cur != BVH_DONE) stack.push(cur, t_cur);                           \
    cur = rr;                                                              \
    t_cur = tt;                                                            \
  }
          BVH_VISIT(sl.h3, sl.r3, sl.t3)
          BVH_VISIT(sl.h2, sl.r2, sl.t2)
          BVH_VISIT(sl.h1, sl.r1, sl.t1)
          BVH_VISIT(sl.h0, sl.r0, sl.t0)
#undef BVH_VISIT
          if (cur == BVH_DONE) cur = stack.pop(t_best, t_cur);
        }
        if (!__any_sync(__activemask(), held == BVH_DONE)) break;  // all hold a leaf
      }
      if (held != BVH_DONE) {
        if (t_held <= t_best &&
            leaf_test<ANY, COUNT>(tris, ~held, leaf_size, r, t_best, bu, bv, prim, w))
          break;
        held = BVH_DONE;
      } else if (cur == BVH_DONE) {
        break;
      }
    }
  }
  if (ANY) {
    hit_out[i] = prim >= 0 ? 1 : 0;
  } else {
    t_out[i] = t_best;
    u_out[i] = bu;
    v_out[i] = bv;
    prim_out[i] = prim;
  }
}

// (BVH_BLOCK, 1): with the block size alone ptxas kept 48 registers and
// spilled 12 bytes to local memory; with a minimum of one block it takes 56
// and spills nothing. `counts` (COUNT only): the int64 sums of the rays,
// box tests and triangle tests.
template <bool ANY, bool COUNT>
__global__ void __launch_bounds__(BVH_BLOCK, 1) bvh_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
    const float* __restrict__ tmax, const float4* __restrict__ wide, int n_wide,
    const float4* __restrict__ tris, int n_rays, int leaf_size, int tile_w,
    int* __restrict__ counter, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ prim_out, unsigned char* __restrict__ hit_out,
    unsigned long long* __restrict__ counts) {
  Stack stack{bvh_stack + threadIdx.x, 0};
  const int lane = threadIdx.x & 31;
  Work w{0u, 0u, 0u};
  while (true) {
    int base = 0;
    if (lane == 0) base = atomicAdd(counter, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_rays) break;
    int i = base + lane;
    if (tile_w) {  // batch base / 32 is that 8x4 tile of the rows of tile_w pixels
      const int b = base >> 5, tiles = tile_w >> 3;
      const int ty = b / tiles, tx = b - ty * tiles;
      i = ((ty << 2) + (lane >> 3)) * tile_w + (tx << 3) + (lane & 7);
    }
    if (i < n_rays)
      trace_ray<ANY, COUNT>(i, origins, dirs, tmin, tmax, wide, n_wide, tris, leaf_size, stack,
                            t_out, u_out, v_out, prim_out, hit_out, w);
    __syncwarp();
  }
  if (COUNT) {  // every lane of the warp left the loop together
    const unsigned rays = __reduce_add_sync(0xffffffffu, w.rays);
    const unsigned boxes = __reduce_add_sync(0xffffffffu, w.boxes);
    const unsigned tests = __reduce_add_sync(0xffffffffu, w.tris);
    if (lane == 0) {
      atomicAdd(counts, (unsigned long long)rays);
      atomicAdd(counts + 1, (unsigned long long)boxes);
      atomicAdd(counts + 2, (unsigned long long)tests);
    }
  }
}

static void* bvh_kernel_of(int any_hit, int count) {
  if (count)
    return any_hit ? reinterpret_cast<void*>(bvh_trace_kernel<true, true>)
                   : reinterpret_cast<void*>(bvh_trace_kernel<false, true>);
  return any_hit ? reinterpret_cast<void*>(bvh_trace_kernel<true, false>)
                 : reinterpret_cast<void*>(bvh_trace_kernel<false, false>);
}

// Launches K7 on `grid` blocks whose threads keep `stack_entries` each in
// shared memory; `counter` is a zeroed int. With tile_w (a multiple of 8
// that divides n_rays / 4) the rays are pixels of rows of tile_w and a
// warp takes an 8x4 tile of them; 0 takes 32 consecutive rays. With
// `counts` (three int64 words, not null) the counting build runs and adds
// the rays walked, box tests and triangle tests to them.
extern "C" int bvh_trace(const float* origins, const float* dirs, float tmin,
                         const float* tmax, const float* wide, int n_wide, const float* tris,
                         int n_rays, int leaf_size, int tile_w, int stack_entries, int any_hit,
                         int grid, int* counter, float* t_out, float* u_out, float* v_out,
                         int* prim_out, unsigned char* hit_out, unsigned long long* counts,
                         int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_wide < 1 || leaf_size < 1 || stack_entries < 1 || stack_entries > BVH_MAX_STACK ||
      grid < 1 || tile_w < 0 || (tile_w && (tile_w % 8 || n_rays % (4 * tile_w))))
    return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const size_t shared = (size_t)stack_entries * BVH_BLOCK * sizeof(int2);
    const float4* w = reinterpret_cast<const float4*>(wide);
    const float4* tr = reinterpret_cast<const float4*>(tris);
#define BVH_LAUNCH(ANY, COUNT)                                                           \
  bvh_trace_kernel<ANY, COUNT><<<grid, BVH_BLOCK, shared, stream>>>(                     \
      origins, dirs, tmin, tmax, w, n_wide, tr, n_rays, leaf_size, tile_w, counter, t_out, \
      u_out, v_out, prim_out, hit_out, counts)
    if (counts) {
      if (any_hit) BVH_LAUNCH(true, true);
      else BVH_LAUNCH(false, true);
    } else {
      if (any_hit) BVH_LAUNCH(true, false);
      else BVH_LAUNCH(false, false);
    }
#undef BVH_LAUNCH
  }
  return (int)cudaGetLastError();
}

// K7's build (`count`: the counting build) on `device` with `stack_entries`
// a thread: out[0] registers a thread, [1] local bytes a thread, [2] static
// shared bytes, [3] dynamic shared bytes a block, [4] resident blocks of
// BVH_BLOCK threads an SM, [5] the SMs.
extern "C" int bvh_trace_info(int any_hit, int count, int stack_entries, int* out,
                              int device) {
  cudaSetDevice(device);
  if (stack_entries < 1 || stack_entries > BVH_MAX_STACK) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bvh_kernel_of(any_hit, count));
  if (err != cudaSuccess) return (int)err;
  const int shared = stack_entries * BVH_BLOCK * (int)sizeof(int2);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, bvh_kernel_of(any_hit, count),
                                                      BVH_BLOCK, shared);
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
