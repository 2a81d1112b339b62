// K2 hit_attributes: per-ray fetch of the hit triangle's attribute row
// and the barycentric interpolation of shading.fetch_hit_attributes.
//
// Replaces capsaicin_tpu/ops/pallas_lookup.py:_lookup_kernel, a row
// lookup of the [T,29] attribute table done as a one-hot matmul on the
// MXU because row gathers are slow on a TPU. A GPU reads the row directly.
//
// Bound: memory. Each ray reads 12 B (prim, u, v) and writes 52 B (P, N,
// UV, kd, texture id, mesh id); the arithmetic is a few dozen FLOP.
//
// Design: one thread per ray, 256 a block. The table (at most 128 rows of
// 29 floats, 14.8 KB) is copied once per block into shared memory, so the
// random row reads never touch device memory. The same thread also does
// the elementwise tail that followed the lookup (clamp prim, interpolate
// P/N/UV with (1-u-v, u, v), normalize N with sqrtf and a division), so
// the [N,29] row block is never written out. Built with --fmad=false to
// keep the plain version's rounding.
#include <cuda_runtime.h>

#define ATTR_MAX_ROWS 128
#define ATTR_COLS 29
#define ATTR_BLOCK 256

__global__ void hit_attributes_kernel(
    const int* __restrict__ prim, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ table, int n,
    int n_rows, float* __restrict__ p_out, float* __restrict__ n_out,
    float* __restrict__ tx_out, float* __restrict__ kd_out,
    int* __restrict__ tex_out, int* __restrict__ mesh_out) {
  __shared__ float s_table[ATTR_MAX_ROWS * ATTR_COLS];
  for (int i = threadIdx.x; i < n_rows * ATTR_COLS; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int p = min(max(prim[i], 0), n_rows - 1);
  const float* a = s_table + ATTR_COLS * p;
  const float uu = u[i], vv = v[i];
  const float w = 1.0f - uu - vv;

  for (int c = 0; c < 3; ++c) p_out[3 * i + c] = a[c] * w + a[3 + c] * uu + a[6 + c] * vv;
  const float nx = a[9] * w + a[12] * uu + a[15] * vv;
  const float ny = a[10] * w + a[13] * uu + a[16] * vv;
  const float nz = a[11] * w + a[14] * uu + a[17] * vv;
  const float len = sqrtf(nx * nx + ny * ny + nz * nz);
  n_out[3 * i] = nx / len;
  n_out[3 * i + 1] = ny / len;
  n_out[3 * i + 2] = nz / len;
  for (int c = 0; c < 2; ++c) tx_out[2 * i + c] = a[18 + c] * w + a[20 + c] * uu + a[22 + c] * vv;
  for (int c = 0; c < 3; ++c) kd_out[3 * i + c] = a[24 + c];
  tex_out[i] = (int)a[27];
  mesh_out[i] = (int)a[28];
}

extern "C" int hit_attributes(const int* prim, const float* u, const float* v,
                              const float* table, int n, int n_rows,
                              float* p_out, float* n_out, float* tx_out,
                              float* kd_out, int* tex_out, int* mesh_out,
                              int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (n_rows < 1 || n_rows > ATTR_MAX_ROWS) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + ATTR_BLOCK - 1) / ATTR_BLOCK;
    hit_attributes_kernel<<<grid, ATTR_BLOCK, 0, stream>>>(
        prim, u, v, table, n, n_rows, p_out, n_out, tx_out, kd_out, tex_out,
        mesh_out);
  }
  return (int)cudaGetLastError();
}
