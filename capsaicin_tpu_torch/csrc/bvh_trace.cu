// K7 bvh_trace: closest-hit and any-hit ray queries against a BVH of any
// size, by an ordered stack walk of the implicit-heap tree.
//
// Replaces capsaicin_tpu/ops/pallas_traverse.py:_traverse_kernel, which
// walks the tree with one node pointer for a whole 1024-ray packet
// (descending where any ray hits a box) because per-lane gathers are slow
// on a TPU. A GPU thread can follow its own ray, so here every ray has its
// own walk and its own stack.
//
// Bound: neither of the card's peaks. The work depends on the rays: on
// the colonnade's 1080p rays the plain walk does a few hundred box tests
// and tens to a hundred triangle tests per ray (PERF.md), which at 67
// TFLOP/s is a bound of a fraction of a millisecond against the few
// milliseconds measured. Each step is a dependent load from a tree of
// 16.6 MB (leaf 4) that stays in the 50 MB L2, so load latency and the
// divergence of a warp's 32 walks limit it.
//
// Design: one thread per ray, 128 a block. A step reads one 64-byte
// sibling-pair record (four float4 loads through the read-only cache),
// slab-tests both children (skipping a child marked empty) and, when the
// children are internal, goes to the near one first and pushes the far
// one on the thread's stack (32 entries, in local memory). Near and far
// come from the pair's code against this ray's own direction sign (the TPU
// kernel used one lane's sign for the packet). When the children are
// leaves, the near leaf's triangles are tested, then the far leaf's if its
// box is still nearer than the best hit. Triangle slots are three float4s
// with the id in a spare lane; the first slot with id -1 ends the leaf
// (padding is at the end of a leaf). The slab test, _safe_inv and the
// Moller-Trumbore arithmetic are those of ops/traverse.py and K1, hits
// accepted on the strict tmin < t < t_best (t_best starts at tmax). An
// any-hit ray returns at its first accepted hit; a dead ray (tmax < tmin)
// does no work. Built with --fmad=false, like every kernel here, so that
// hits on triangle edges agree with the plain version.
#include <cuda_runtime.h>

#define BVH_BLOCK 128
#define BVH_STACK 32

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

__device__ __forceinline__ float safe_inv(float d) {
  return fabsf(d) < 1e-12f ? (d < 0.0f ? -1e12f : 1e12f) : 1.0f / d;
}

// Slab test of the box lo..hi; t_near is written for the caller's
// ordering, the result is the plain version's test.
__device__ __forceinline__ bool slab(const Ray& r, float lx, float ly, float lz, float hx,
                                     float hy, float hz, float t_best, float& t_near) {
  const float tx0 = (lx - r.ox) * r.ix, tx1 = (hx - r.ox) * r.ix;
  const float ty0 = (ly - r.oy) * r.iy, ty1 = (hy - r.oy) * r.iy;
  const float tz0 = (lz - r.oz) * r.iz, tz1 = (hz - r.oz) * r.iz;
  t_near = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
  const float t_far = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return t_near <= t_far && t_far >= r.tmin && t_near <= t_best;
}

// The triangles of one leaf, in slot order. Returns true on an accepted
// hit when any_hit is set (the caller stops there).
__device__ __forceinline__ bool leaf_test(const float4* __restrict__ tris, int leaf,
                                          int leaf_size, const Ray& r, int any_hit,
                                          float& t_best, float& bu, float& bv, int& prim) {
  const float4* tr = tris + 3 * (size_t)leaf * leaf_size;
  for (int j = 0; j < leaf_size; ++j, tr += 3) {
    const float4 a = __ldg(tr);
    const int tid = __float_as_int(a.w);
    if (tid < 0) break;
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
      if (any_hit) return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(BVH_BLOCK) bvh_trace_kernel(
    const float* __restrict__ origins, const float* __restrict__ dirs, float tmin,
    const float* __restrict__ tmax, const float4* __restrict__ nodes,
    const float4* __restrict__ tris, int n_rays, int n_leaves, int leaf_size,
    int any_hit, float* __restrict__ t_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ prim_out,
    unsigned char* __restrict__ hit_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
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
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    int stack[BVH_STACK];
    int sp = 0;
    int k = 1;  // the root: internal, since a tree has at least 2 leaves
    while (true) {
      const float4* rec = nodes + 4 * (size_t)k;
      const float4 lmin = __ldg(rec), lmax = __ldg(rec + 1);
      const float4 rmin = __ldg(rec + 2), rmax = __ldg(rec + 3);
      const int code = (int)lmin.w;
      const int empty = (int)lmax.w;
      float t_l = 0.0f, t_r = 0.0f;
      const bool hit_l = !(empty & 1) &&
                         slab(r, lmin.x, lmin.y, lmin.z, lmax.x, lmax.y, lmax.z, t_best, t_l);
      const bool hit_r = !(empty & 2) &&
                         slab(r, rmin.x, rmin.y, rmin.z, rmax.x, rmax.y, rmax.z, t_best, t_r);
      const int axis = code & 3;
      const bool d_pos = axis == 0 ? r.dx > 0.0f : (axis == 1 ? r.dy > 0.0f : r.dz > 0.0f);
      const bool near_left = d_pos == (code >= 4);
      const int c0 = 2 * k;
      const int near = near_left ? c0 : c0 + 1, far = near_left ? c0 + 1 : c0;
      const bool hit_near = near_left ? hit_l : hit_r, hit_far = near_left ? hit_r : hit_l;
      if (c0 >= n_leaves) {
        if (hit_near &&
            leaf_test(tris, near - n_leaves, leaf_size, r, any_hit, t_best, bu, bv, prim))
          break;
        if (hit_far && (near_left ? t_r : t_l) <= t_best &&
            leaf_test(tris, far - n_leaves, leaf_size, r, any_hit, t_best, bu, bv, prim))
          break;
      } else if (hit_near) {
        if (hit_far) stack[sp++] = far;
        k = near;
        continue;
      } else if (hit_far) {
        k = far;
        continue;
      }
      if (sp == 0) break;
      k = stack[--sp];
    }
  }
  if (any_hit) {
    hit_out[i] = prim >= 0 ? 1 : 0;
  } else {
    t_out[i] = t_best;
    u_out[i] = bu;
    v_out[i] = bv;
    prim_out[i] = prim;
  }
}

extern "C" int bvh_trace(const float* origins, const float* dirs, float tmin,
                         const float* tmax, const float* nodes, const float* tris,
                         int n_rays, int n_leaves, int leaf_size, int any_hit, float* t_out,
                         float* u_out, float* v_out, int* prim_out, unsigned char* hit_out,
                         int device, cudaStream_t stream) {
  cudaSetDevice(device);
  // the stack holds depth - 2 entries; depth = log2(n_leaves)
  if (n_leaves < 2 || (n_leaves & (n_leaves - 1)) || leaf_size < 1 ||
      __builtin_ctz((unsigned)n_leaves) > BVH_STACK)
    return (int)cudaErrorInvalidValue;
  if (n_rays > 0) {
    const int grid = (n_rays + BVH_BLOCK - 1) / BVH_BLOCK;
    bvh_trace_kernel<<<grid, BVH_BLOCK, 0, stream>>>(
        origins, dirs, tmin, tmax, reinterpret_cast<const float4*>(nodes),
        reinterpret_cast<const float4*>(tris), n_rays, n_leaves, leaf_size, any_hit, t_out,
        u_out, v_out, prim_out, hit_out);
  }
  return (int)cudaGetLastError();
}
