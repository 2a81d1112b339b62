// K12 feedback_fetch: the bounce loop's GBUFFER_FEEDBACK fetch
// (ops/feedback.py, rt_indirect.hlsl:110-135). Each lane reprojects its
// bounce hit into the previous camera, reads the previous frame's combined
// colour and depth at the four bilinear corners (each rounded to fp16, as
// the reference's RGBA16F history is), blends the colour and tests the
// point-fetched depth against the hit's distance (5%).
//
// Replaces no TPU kernel: it is the port's form of the inline jnp fetch of
// capsaicin_tpu/render/passes.py:308-377. It was added because the eager
// fetch (about 80 PyTorch launches, among them four row gathers that each
// schedule one block per lane) cost about 100 ms of an offline64 frame on
// the H100; the work is a few hundred instructions and 25 B a lane.
//
// Bound: memory. A lane reads its hit (12 B) and writes its colour (12 B)
// and flag (1 B); the [H,W,3] colour and [H,W] depth (33 MB at 1080p) fit
// in the H100's 50 MB L2, so the corners of neighbouring lanes are shared
// there. The camera, a few dozen floats, is read by every lane from the
// read-only cache, so nothing is read back to the host.
//
// Design: one thread a lane, 256 a block, every lane computed (dead lanes
// too; the caller masks them). The arithmetic follows feedback_fetch_plain
// operation for operation under the library's --fmad=false, so the result
// is bit-equal to the plain version on the card: dot products add left to
// right (mathops.sum_last), uv_to_xy's torch.minimum keeps a NaN where
// fminf would drop it, pixel_index maps NaN to `lo` before it clamps, the +1
// corner wraps (x + 1) % width, and clamp_min keeps a NaN distance (a hit
// at the camera's position gives 0/0).
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define FEEDBACK_BLOCK 256

// x rounded to fp16 and back: .half().float()
__device__ __forceinline__ float fp16(float x) { return __half2float(__float2half_rn(x)); }

// torch.minimum: a NaN operand wins
__device__ __forceinline__ float nan_minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// resample.pixel_index: NaN -> lo, then clamp to [lo, hi] (nan_to_num's +-inf
// become +-FLT_MAX, which the clamp takes to hi or lo as it takes +-inf)
__device__ __forceinline__ int pixel_index(float x, int lo, int hi) {
  if (isnan(x)) x = (float)lo;
  return (int)fminf(fmaxf(x, (float)lo), (float)hi);
}

__global__ void feedback_fetch_kernel(
    const float* __restrict__ p, int n, const float* __restrict__ cam_pos,
    const float* __restrict__ cam_right, const float* __restrict__ cam_forward,
    const float* __restrict__ cam_up, const float* __restrict__ cam_focal,
    const float* __restrict__ cam_sensor, const float* __restrict__ color,
    const float* __restrict__ depth, int width, int height, float* __restrict__ hist,
    unsigned char* __restrict__ disocc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float cx = __ldg(cam_pos), cy = __ldg(cam_pos + 1), cz = __ldg(cam_pos + 2);
  const float fx = __ldg(cam_forward), fy = __ldg(cam_forward + 1), fz = __ldg(cam_forward + 2);
  const float focal = __ldg(cam_focal);

  // camera.calculate_image_plane_uv
  const float vx = __ldg(p + 3 * (size_t)i) - cx, vy = __ldg(p + 3 * (size_t)i + 1) - cy,
              vz = __ldg(p + 3 * (size_t)i + 2) - cz;
  const float dist = sqrtf(vx * vx + vy * vy + vz * vz);  // also cur_d
  const float dx = vx / dist, dy = vy / dist, dz = vz / dist;
  const float flen = sqrtf(fx * fx + fy * fy + fz * fz);
  const float nx = fx / flen, ny = fy / flen, nz = fz / flen;
  const float qx = cx + nx * focal, qy = cy + ny * focal, qz = cz + nz * focal;
  const float t = (nx * (qx - cx) + ny * (qy - cy) + nz * (qz - cz)) /
                  (nx * dx + ny * dy + nz * dz);
  const float ix = (cx + t * dx) - qx, iy = (cy + t * dy) - qy, iz = (cz + t * dz) - qz;
  const float u = (ix * __ldg(cam_right) + iy * __ldg(cam_right + 1) + iz * __ldg(cam_right + 2)) /
                  (0.5f * __ldg(cam_sensor));
  const float v = (ix * __ldg(cam_up) + iy * __ldg(cam_up + 1) + iz * __ldg(cam_up + 2)) /
                  (0.5f * __ldg(cam_sensor + 1));
  const float uvx = 0.5f * u + 0.5f, uvy = 0.5f * v + 0.5f;
  const bool offscreen = uvx < 0.0f || uvx > 1.0f || uvy < 0.0f || uvy > 1.0f;
  // resample.uv_to_xy
  const float xf = nan_minimum(uvx * (float)width, (float)(width - 1));
  const float yf = nan_minimum(uvy * (float)height, (float)(height - 1));

  // the bilinear corners
  const float x0 = xf - 0.5f, y0 = yf - 0.5f;
  const float flx = floorf(x0), fly = floorf(y0);
  const int bx = pixel_index(flx, -1, width - 1), by = pixel_index(fly, -1, height - 1);
  const float wx = bx < 0 ? 0.0f : x0 - flx;
  const float wy = by < 0 ? 0.0f : y0 - fly;
  const int bxc = max(bx, 0), byc = max(by, 0);
  const int x1 = (bxc + 1) % width, y1 = (byc + 1) % height;
  const size_t k00 = (size_t)byc * width + bxc, k10 = (size_t)byc * width + x1,
               k01 = (size_t)y1 * width + bxc, k11 = (size_t)y1 * width + x1;
  const float owx = 1.0f - wx, owy = 1.0f - wy;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = fp16(__ldg(color + 3 * k00 + c)) * owx + fp16(__ldg(color + 3 * k10 + c)) * wx;
    const float bot = fp16(__ldg(color + 3 * k01 + c)) * owx + fp16(__ldg(color + 3 * k11 + c)) * wx;
    hist[3 * (size_t)i + c] = top * owy + bot * wy;
  }

  // the point fetch is one of the corners
  const int di = pixel_index(floorf(xf), 0, width - 1) - bxc;
  const int dj = pixel_index(floorf(yf), 0, height - 1) - byc;
  const size_t kd = dj == 0 ? (di == 0 ? k00 : k10) : (di == 0 ? k01 : k11);
  const float prev_d = fp16(__ldg(depth + kd));
  const float floor_d = isnan(dist) ? dist : fmaxf(dist, 1e-20f);
  disocc[i] = offscreen || fabsf(prev_d - dist) / floor_d > 0.05f;
}

extern "C" int feedback_fetch(const float* p, int n, const float* cam_pos, const float* cam_right,
                              const float* cam_forward, const float* cam_up,
                              const float* cam_focal, const float* cam_sensor, const float* color,
                              const float* depth, int width, int height, float* hist,
                              unsigned char* disocc, int device, cudaStream_t stream) {
  cudaSetDevice(device);
  if (width < 1 || height < 1) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = (n + FEEDBACK_BLOCK - 1) / FEEDBACK_BLOCK;
    feedback_fetch_kernel<<<grid, FEEDBACK_BLOCK, 0, stream>>>(
        p, n, cam_pos, cam_right, cam_forward, cam_up, cam_focal, cam_sensor, color, depth,
        width, height, hist, disocc);
  }
  return (int)cudaGetLastError();
}

// K12's build: registers and local bytes a thread, static shared bytes a
// block, resident blocks an SM, SMs
extern "C" int feedback_fetch_info(int* out, int device) {
  cudaSetDevice(device);
  const void* fn = reinterpret_cast<const void*>(feedback_fetch_kernel);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, FEEDBACK_BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = blocks;
  out[4] = sms;
  return (int)cudaSuccess;
}
