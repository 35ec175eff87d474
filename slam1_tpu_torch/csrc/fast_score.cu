// FAST-9 corner score map for Hopper (sm_90a).
//
// Replaces: slam1_tpu/ops/pallas_kernels.py:fast_score (kernel body
// _fast_kernel), the TPU kernel that scores row strips held in VMEM.
//
// What it computes: for each pixel, the 16 taps of the radius-3
// Bresenham circle. The pixel is a corner when >= `arc` consecutive
// taps are all brighter than centre + t or all darker than centre - t;
// its score is max over the two polarities of sum(max(|diff| - t, 0)),
// summed in circle order 0..15 (the plain twin's order, so the result
// is bit-identical and NMS keeps the same pixels). Pixels within 3 px
// of the border score 0.
//
// What bounds it on the H100: device-memory bytes. Each pixel is read
// once and written once (8 B/pixel; 2 images x 3 levels of a 376x1280
// frame is 10.1 MB, 0.0030 ms at 3.35 TB/s), against ~110 float32
// operations per pixel for the score itself (0.0021 ms at the float32
// peak). Measured: 0.039 ms of device time per frame for the three
// launches (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), 8 % of
// that bound; at these sizes launch latency dominates.
//
// Design: one thread per pixel, a 32x8 block per tile, the tile plus a
// 3-px halo staged in shared memory so the 16 taps of neighbouring
// threads are read from HBM once. The batch (left and right images)
// is the grid's z dimension: one launch per pyramid level. Run-length
// counting over 16 + arc - 1 taps replaces the branchy per-pixel scan.
// Build with --fmad=false: the score must round as the plain twin's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int R = 3;  // circle radius == border width

__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                            3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                            0, -1, -2, -3, -3, -3, -2, -1};

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int H, int W,
                                  float thr, int arc) {
  __shared__ float tile[TY + 2 * R][TX + 2 * R];
  const int b = blockIdx.z;
  const float* src = img + static_cast<size_t>(b) * H * W;
  const int x0 = blockIdx.x * TX;
  const int y0 = blockIdx.y * TY;
  const int tid = threadIdx.y * TX + threadIdx.x;

  // Stage the tile and its halo (zeros outside the image; those values
  // only feed border pixels, which are zeroed below).
  for (int i = tid; i < (TY + 2 * R) * (TX + 2 * R); i += TX * TY) {
    const int ly = i / (TX + 2 * R);
    const int lx = i % (TX + 2 * R);
    const int gy = y0 + ly - R;
    const int gx = x0 + lx - R;
    tile[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                       ? src[static_cast<size_t>(gy) * W + gx]
                       : 0.0f;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;

  float score = 0.0f;
  if (y >= R && y < H - R && x >= R && x < W - R) {
    const int ly = threadIdx.y + R;
    const int lx = threadIdx.x + R;
    const float c = tile[ly][lx];
    int run_b = 0, run_d = 0;
    bool corner = false;
    float score_b = 0.0f, score_d = 0.0f;
    const int n_taps = 16 + arc - 1;
    for (int t = 0; t < n_taps; ++t) {
      const int k = t & 15;
      const float diff = tile[ly + kDy[k]][lx + kDx[k]] - c;
      run_b = diff > thr ? run_b + 1 : 0;
      run_d = diff < -thr ? run_d + 1 : 0;
      corner = corner || run_b >= arc || run_d >= arc;
      if (t < 16) {
        score_b = score_b + fmaxf(diff - thr, 0.0f);
        score_d = score_d + fmaxf(-diff - thr, 0.0f);
      }
    }
    score = corner ? fmaxf(score_b, score_d) : 0.0f;
  }
  out[static_cast<size_t>(b) * H * W + static_cast<size_t>(y) * W + x] =
      score;
}

}  // namespace

// img, out: (B, H, W) float32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch.
extern "C" int slam_fast_score(const float* img, float* out, int B, int H,
                               int W, float threshold, int arc,
                               void* stream) {
  dim3 block(TX, TY);
  dim3 grid((W + TX - 1) / TX, (H + TY - 1) / TY, B);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, out, H, W, threshold, arc);
  return static_cast<int>(cudaGetLastError());
}
