// Square-root chain preconditioner of the pose-graph CG, for Hopper
// (sm_90a).
//
// Replaces: the two lax.scan sweeps of
// slam1_tpu/models/posegraph.py:_chain_sqrt_solve (an XLA scan in the
// reference, not a Pallas kernel). For pose-indexed rows i in [1, F):
//   backward  s_i = JjInv_i^T (v_i - Ji_{i+1}^T s_{i+1}),  s_F = 0
//   scale     u_i = winv_i s_i
//   forward   x_i = JjInv_i (u_i - Ji_i x_{i-1}),          x_0 = 0
// with x_0 = 0 on output. Rows from `n_live` on must be decoupled from
// the chain (Ji = 0 and JjInv = I there: no chain edge reaches them),
// so their solution is x_i = winv_i v_i exactly and the sweeps stop at
// n_live - 1; with n_live = F this is the reference's recurrence.
//
// What bounds it on the H100: latency. Each row depends on the one
// before, so one thread marches the chain with the running 6-vector in
// registers, in the reference's order of operations (each 6x6 product
// summed over b = 0..5; --fmad=false keeps products and sums rounded
// apart). The block's other threads stage the next rows' 6x6 blocks
// into shared memory, CHUNK rows at a time, so the marching thread
// reads no device memory, and write the decoupled rows in parallel.
// One launch per preconditioner application (both sweeps).

#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;      // rows staged in shared memory per step
constexpr int THREADS = 128;

__global__ void chain_sweep_kernel(const float* __restrict__ jj_inv,
                                   const float* __restrict__ ji,
                                   const float* __restrict__ winv,
                                   const float* __restrict__ v, int F,
                                   int n_live, float* __restrict__ x) {
  __shared__ float s_jj[CHUNK * 36];
  __shared__ float s_ji[CHUNK * 36];
  __shared__ float s_vec[CHUNK * 6];
  __shared__ float s_w[CHUNK];

  for (int k = threadIdx.x; k < F * 6; k += blockDim.x) {
    const int i = k / 6;
    if (i == 0) {
      x[k] = 0.0f;
    } else if (i >= n_live) {
      x[k] = winv[i] * v[k];
    }
  }

  // Backward sweep, top chunk first; s_{i} goes into x[i] for now.
  float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int hi = n_live; hi > 1; hi -= CHUNK) {
    const int lo = max(1, hi - CHUNK);
    const int rows = hi - lo;
    __syncthreads();
    for (int k = threadIdx.x; k < rows * 36; k += blockDim.x) {
      s_jj[k] = jj_inv[static_cast<size_t>(lo) * 36 + k];
      const int r = lo + 1 + k / 36;           // Ji of the next row
      s_ji[k] = r < n_live ? ji[static_cast<size_t>(r) * 36 + k % 36] : 0.0f;
    }
    for (int k = threadIdx.x; k < rows * 6; k += blockDim.x) {
      s_vec[k] = v[static_cast<size_t>(lo) * 6 + k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = hi - 1; i >= lo; --i) {
        const float* jn = s_ji + (i - lo) * 36;
        const float* jj = s_jj + (i - lo) * 36;
        const float* vi = s_vec + (i - lo) * 6;
        float t[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          float w = 0.0f;
#pragma unroll
          for (int b = 0; b < 6; ++b) w += jn[b * 6 + a] * s[b];
          t[a] = vi[a] - w;
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          float acc = 0.0f;
#pragma unroll
          for (int b = 0; b < 6; ++b) acc += jj[b * 6 + a] * t[b];
          s[a] = acc;
          x[static_cast<size_t>(i) * 6 + a] = acc;
        }
      }
    }
  }

  // Forward sweep over the scaled s.
  float xp[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int lo = 1; lo < n_live; lo += CHUNK) {
    const int hi = min(n_live, lo + CHUNK);
    const int rows = hi - lo;
    __syncthreads();
    for (int k = threadIdx.x; k < rows * 36; k += blockDim.x) {
      s_jj[k] = jj_inv[static_cast<size_t>(lo) * 36 + k];
      s_ji[k] = ji[static_cast<size_t>(lo) * 36 + k];
    }
    for (int k = threadIdx.x; k < rows * 6; k += blockDim.x) {
      s_vec[k] = x[static_cast<size_t>(lo) * 6 + k];
    }
    for (int k = threadIdx.x; k < rows; k += blockDim.x) {
      s_w[k] = winv[lo + k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = lo; i < hi; ++i) {
        const float* jc = s_ji + (i - lo) * 36;
        const float* jj = s_jj + (i - lo) * 36;
        const float* si = s_vec + (i - lo) * 6;
        const float wi = s_w[i - lo];
        float t[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          float w = 0.0f;
#pragma unroll
          for (int b = 0; b < 6; ++b) w += jc[a * 6 + b] * xp[b];
          t[a] = wi * si[a] - w;
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          float acc = 0.0f;
#pragma unroll
          for (int b = 0; b < 6; ++b) acc += jj[a * 6 + b] * t[b];
          x[static_cast<size_t>(i) * 6 + a] = acc;
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) xp[a] = x[static_cast<size_t>(i) * 6 + a];
      }
    }
  }
}

}  // namespace

// jj_inv, ji: (F, 6, 6) float32 row-major; winv (F,); v (F, 6); output
// x (F, 6). 1 <= n_live <= F. Returns cudaGetLastError() after the
// launch.
extern "C" int slam_chain_sweep(const float* jj_inv, const float* ji,
                                const float* winv, const float* v, int F,
                                int n_live, float* x, void* stream) {
  chain_sweep_kernel<<<1, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      jj_inv, ji, winv, v, F, n_live, x);
  return static_cast<int>(cudaGetLastError());
}
