// The observation pass of bundle adjustment's CG path for BAL's cameras,
// for Hopper (sm_90a): per monocular observation the residual, the Huber
// weight, the robust cost, the analytic Jacobians and the normal-equation
// blocks, each observation visited once per launch and nothing but the
// blocks written. The stereo rig's pass is csrc/ba_obs.cu; this file
// keeps its launches and its precision rules at BAL's 9-parameter
// cameras and 2 residuals, without its graduated outlier cut: BAL's
// model weights every observation by Huber alone, as the reference's
// `bal_adjust` does, so the truncated cost the contract returns is the
// full one.
//
// Replaces no TPU kernel. The reference (slam1_tpu/models/bal.py
// `bal_adjust`, `_schur_solve9`) takes `jax.jacfwd` of the projection and
// writes the blocks as einsums and segment sums that XLA fuses.
//
//   slam_bal_obs_cameras    one block a camera, over the camera ordering:
//                           the cost at the estimate, the coupling block
//                           W_o = Jc^T Jl w of every row (O,9,3), and by
//                           camera Hcc = sum Jc^T Jc w (C,9,9) and bc =
//                           -sum Jc^T r w (C,9); rows the ordering leaves
//                           out get W_o = 0 (the launch's last blocks).
//   slam_bal_obs_landmarks  one thread a landmark, over the landmark
//                           ordering: Hll = sum Jl^T Jl w (L,3,3) and
//                           bl = -sum Jl^T r w (L,3), the row's camera
//                           worked out again from its 9 parameters.
//   slam_bal_obs_cost       the cameras launch's cost alone, at another
//                           estimate: the cost after the step and the
//                           final cost.
//
// The camera model, BAL's (Agarwal et al., "Bundle Adjustment in the
// Large"; `models/bal.project`): camera c = [w (3), t (3), f, k1, k2],
// R = exp(hat(w)) by Rodrigues (theta^2 < 1e-8: the series), q = R X,
// P = q + t, p = -(P_x, P_y) / P_z (P_z replaced by sign(P_z) 1e-9 + 1e-12
// where |P_z| <= 1e-9), r2 = |p|^2, uv = f (1 + k1 r2 + k2 r2^2) p, the
// residual uv minus the observation. The parameters move additively
// (c + dc), so
//   d uv / d p = f d I + f (2 k1 + 4 k2 r2) p p^T,  d = 1 + k1 r2 + k2 r2^2
//   d p / d P  = [[-1/P_z, 0, P_x/P_z^2], [0, -1/P_z, P_y/P_z^2]]
//                (the last column 0 where P_z is replaced)
//   d P / d w  = -hat(q) J_l(w),  J_l = I + b hat(w) + c hat(w)^2,
//                b = (1 - cos theta) / theta^2, c = (1 - sin theta / theta)
//                / theta^2 (theta^2 < 1e-2: its series), d P / d t = I,
//   d P / d X  = R,  d uv / d (f, k1, k2) = (d p, f r2 p, f r2^2 p).
// The residual's weight: hw = 1 (|r|^2 <= delta^2) or sqrt(delta^2 /
// max(|r|^2, 1e-12)), the step's w = w_o hw; the cost sum w_o hw |r|^2.
//
// Precision, as csrc/ba_obs.cu: every observation's terms in float32
// (--fmad=false: a multiply and an add each; IEEE division and square
// root), in the order of the plain twin's operations (`ops/bal_obs.py`);
// the sums over a landmark's or a camera's observations in float64,
// rounded once to float32. No atomics: a landmark's sums run in its
// ordering's order in one thread, a camera's as per-thread partial sums
// combined by a fixed shuffle tree and then warp by warp; the cost's
// per-camera partials are summed camera by camera in a fixed order by one
// block and rounded once. The same operands give the same bits on every
// run, and the cameras launch and the cost launch give the same cost to
// the bit at the same estimate (one loop body and one reduction for both),
// so the strict accept cost_new < cost_cur compares two sums taken in one
// order. Against the twin on the CPU the sines and cosines and the order
// of the float64 sums differ: `tests/test_torch_kernels_cuda.py` states
// the tolerance (`BAL_TOL`).
//
// What bounds it on the H100: bytes (`utils/bounds.bal_obs_work`). The
// cameras launch reads each observation's 20 bytes (uv, w, its ordering
// row and landmark) and its point (12 bytes, gathered) and writes W
// (108 bytes); the landmarks launch and the cost launch read the 20
// bytes and the camera (36 bytes, from L2).

#include <cuda_runtime.h>

// What every entry reads, as `cuda_kernels._BalArgs` lays it out. All
// pointers are device pointers.
struct BalArgs {
  const float* cams;      // (C,9) [w, t, f, k1, k2]
  const float* points;    // (L,3)
  const float* uv;        // (O,2), 8-byte aligned
  const float* w;         // (O,) the observation's weight
  const int* cam_rows;    // (O,) rows by camera; cam_lms[k] their landmarks
  const int* cam_lms;
  const int* cam_off;     // (C+1,)
  const int* lm_rows;     // (O,) rows by landmark; lm_cams[k] their cameras
  const int* lm_cams;
  const int* lm_off;      // (L+1,)
  float delta2;           // squared Huber delta, rounded to float32
  int n_cams;
  int n_lms;
  int n_obs;
};

namespace {

constexpr int CAM_THREADS = 128;
constexpr int CAM_WARPS = CAM_THREADS / 32;
constexpr int LM_THREADS = 128;
constexpr int SUM_THREADS = 256;
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int TAIL_BLOCKS = 32;
constexpr float R2_MIN = 1e-12f;
// A camera's float64 sums: the cost, rows kept, Hcc's upper triangle (45),
// bc (9).
constexpr int N_COST = 2;
constexpr int N_TERMS = N_COST + 45 + 9;

// A camera worked out from its 9 parameters: R (row-major), J_l
// (row-major), t, f, k1, k2.
struct Cam9 {
  float R[9], J[9], t[3], f, k1, k2;
};

// hat(w) @ hat(w), row-major, as a 3x3 product summed from k = 0.
__device__ __forceinline__ void hat_sq(const float K[9], float K2[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = K[3 * i] * K[j];
      acc = acc + K[3 * i + 1] * K[3 + j];
      acc = acc + K[3 * i + 2] * K[6 + j];
      K2[3 * i + j] = acc;
    }
  }
}

__device__ __forceinline__ Cam9 load_cam(const float* __restrict__ cams,
                                         int cam) {
  const float* q = cams + static_cast<size_t>(cam) * 9;
  float w[3];
  Cam9 k;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    w[i] = __ldg(q + i);
    k.t[i] = __ldg(q + 3 + i);
  }
  k.f = __ldg(q + 6);
  k.k1 = __ldg(q + 7);
  k.k2 = __ldg(q + 8);
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < 1e-8f;
  const float theta = sqrtf(small ? 1.0f : th2);
  const float a = small ? 1.0f - th2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(theta)) / th2;
  const float c = th2 < 1e-2f
                      ? 1.0f / 6.0f - th2 / 120.0f + th2 * th2 / 5040.0f
                      : (1.0f - sinf(theta) / theta) / th2;
  const float K[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0],
                      -w[1], w[0], 0.0f};
  float K2[9];
  hat_sq(K, K2);
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    k.R[i] = eye + a * K[i] + b * K2[i];
    k.J[i] = eye + b * K[i] + c * K2[i];
  }
  return k;
}

// One observation at the estimate.
struct Obs {
  float q[3], P[3], p[2], r[2], den, r2p, d, s, rr2, hw, wt;
  bool free;
};

__device__ __forceinline__ Obs observe(const BalArgs& a, const Cam9& k,
                                       const float X[3], int o) {
  Obs s;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = k.R[3 * j] * X[0];
    acc = acc + k.R[3 * j + 1] * X[1];
    acc = acc + k.R[3 * j + 2] * X[2];
    s.q[j] = acc;
    s.P[j] = acc + k.t[j];
  }
  s.free = fabsf(s.P[2]) > 1e-9f;
  const float sgn = s.P[2] > 0.0f ? 1.0f : (s.P[2] < 0.0f ? -1.0f : 0.0f);
  s.den = s.free ? s.P[2] : sgn * 1e-9f + 1e-12f;
  s.p[0] = -s.P[0] / s.den;
  s.p[1] = -s.P[1] / s.den;
  s.r2p = s.p[0] * s.p[0] + s.p[1] * s.p[1];
  s.d = 1.0f + k.k1 * s.r2p + k.k2 * s.r2p * s.r2p;
  s.s = k.f * s.d;
  const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv) + o);
  s.r[0] = s.s * s.p[0] - uv.x;
  s.r[1] = s.s * s.p[1] - uv.y;
  s.rr2 = s.r[0] * s.r[0] + s.r[1] * s.r[1];
  s.hw = s.rr2 <= a.delta2
             ? 1.0f
             : sqrtf(a.delta2 / (s.rr2 < R2_MIN ? R2_MIN : s.rr2));
  s.wt = __ldg(a.w + o) * s.hw;
  return s;
}

// A = d uv / d P (2x3, row-major).
__device__ __forceinline__ void point_jacobian(const Cam9& k, const Obs& s,
                                               float A[6]) {
  const float g = k.f * (2.0f * k.k1 + 4.0f * k.k2 * s.r2p);
  const float J00 = s.s + g * s.p[0] * s.p[0];
  const float J01 = g * s.p[0] * s.p[1];
  const float J10 = g * s.p[1] * s.p[0];
  const float J11 = s.s + g * s.p[1] * s.p[1];
  const float idn = 1.0f / s.den;
  const float dz0 = s.free ? s.P[0] * idn * idn : 0.0f;
  const float dz1 = s.free ? s.P[1] * idn * idn : 0.0f;
  A[0] = J00 * -idn;
  A[1] = J01 * -idn;
  A[2] = J00 * dz0 + J01 * dz1;
  A[3] = J10 * -idn;
  A[4] = J11 * -idn;
  A[5] = J10 * dz0 + J11 * dz1;
}

// Jl = A R (2x3).
__device__ __forceinline__ void landmark_jacobian(const float A[6],
                                                  const float R[9],
                                                  float Jl[6]) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = A[3 * p] * R[j];
      acc = acc + A[3 * p + 1] * R[3 + j];
      acc = acc + A[3 * p + 2] * R[6 + j];
      Jl[3 * p + j] = acc;
    }
  }
}

// Jc (2x9, row-major): [A (-hat(q) J_l), A, d p, f r2 p, f r2^2 p].
__device__ __forceinline__ void camera_jacobian(const Cam9& k, const Obs& s,
                                                const float A[6],
                                                float Jc[18]) {
  const float H[9] = {0.0f, -s.q[2], s.q[1], s.q[2], 0.0f, -s.q[0],
                      -s.q[1], s.q[0], 0.0f};
  float M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = H[3 * i] * k.J[j];
      acc = acc + H[3 * i + 1] * k.J[3 + j];
      acc = acc + H[3 * i + 2] * k.J[6 + j];
      M[3 * i + j] = -acc;
    }
  }
  const float fr2 = k.f * s.r2p;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = A[3 * p] * M[j];
      acc = acc + A[3 * p + 1] * M[3 + j];
      acc = acc + A[3 * p + 2] * M[6 + j];
      Jc[9 * p + j] = acc;
      Jc[9 * p + 3 + j] = A[3 * p + j];
    }
    Jc[9 * p + 6] = s.d * s.p[p];
    Jc[9 * p + 7] = fr2 * s.p[p];
    Jc[9 * p + 8] = fr2 * s.r2p * s.p[p];
  }
}

__device__ __forceinline__ void load_point(const float* __restrict__ points,
                                           int l, float X[3]) {
  const float* p = points + static_cast<size_t>(l) * 3;
  X[0] = __ldg(p); X[1] = __ldg(p + 1); X[2] = __ldg(p + 2);
}

__device__ __forceinline__ void add_costs(const Obs& s, float pw,
                                          double acc[N_COST]) {
  acc[0] += static_cast<double>(pw * s.hw * s.rr2);
  acc[1] += s.wt > 0.0f ? 1.0 : 0.0;
}

// Index (i, j), i <= j, of the k-th entry of a 9x9 upper triangle, row by
// row.
__device__ __forceinline__ void tri9(int k, int& i, int& j) {
  i = 0;
  int row = 9;
  while (k >= row) {
    k -= row;
    --row;
    ++i;
  }
  j = i + k;
}

// TERMS: the cameras launch (W, Hcc, bc and the cost); otherwise the cost
// launch. Both take the same rows in the same threads and reduce them the
// same way, so their costs agree to the bit.
template <bool TERMS>
__global__ void __launch_bounds__(CAM_THREADS)
bal_cameras_kernel(BalArgs a, float* __restrict__ W, float* __restrict__ hcc,
                   float* __restrict__ bc, double* __restrict__ part) {
  constexpr int N = TERMS ? N_TERMS : N_COST;
  const int c = blockIdx.x;
  if (TERMS && c >= a.n_cams) {
    // The rows the ordering leaves out follow every camera's rows.
    const int step = TAIL_BLOCKS * CAM_THREADS;
    for (int k = __ldg(a.cam_off + a.n_cams) + (c - a.n_cams) * CAM_THREADS +
                 threadIdx.x;
         k < a.n_obs; k += step) {
      float* dst = W + static_cast<size_t>(__ldg(a.cam_rows + k)) * 27;
#pragma unroll
      for (int i = 0; i < 27; ++i) dst[i] = 0.0f;
    }
    return;
  }
  __shared__ double red[CAM_WARPS][N];
  const Cam9 k = load_cam(a.cams, c);
  double acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0;
  const int beg = __ldg(a.cam_off + c);
  const int end = __ldg(a.cam_off + c + 1);
  for (int q = beg + threadIdx.x; q < end; q += CAM_THREADS) {
    const int o = __ldg(a.cam_rows + q);
    float X[3];
    load_point(a.points, __ldg(a.cam_lms + q), X);
    const Obs s = observe(a, k, X, o);
    add_costs(s, __ldg(a.w + o), acc);
    if (TERMS) {
      float A[6], Jl[6], Jc[18];
      point_jacobian(k, s, A);
      landmark_jacobian(A, k.R, Jl);
      camera_jacobian(k, s, A, Jc);
      const float rw[2] = {s.r[0] * s.wt, s.r[1] * s.wt};
      float* dst = W + static_cast<size_t>(o) * 27;
#pragma unroll
      for (int i = 0; i < 9; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float m = Jc[i] * Jl[j];
          m = m + Jc[9 + i] * Jl[3 + j];
          dst[3 * i + j] = m * s.wt;
        }
      }
      int n = N_COST;
#pragma unroll
      for (int i = 0; i < 9; ++i) {
#pragma unroll
        for (int j = i; j < 9; ++j) {
          float m = Jc[i] * Jc[j];
          m = m + Jc[9 + i] * Jc[9 + j];
          acc[n++] += static_cast<double>(m * s.wt);
        }
      }
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        float m = Jc[i] * rw[0];
        m = m + Jc[9 + i] * rw[1];
        acc[n++] += static_cast<double>(m);
      }
    }
  }
  // Fixed-order tree within the warp, then the warps in order.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], d);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[warp][i] = acc[i];
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= N) return;
  double sum = red[0][i];
#pragma unroll
  for (int q = 1; q < CAM_WARPS; ++q) sum += red[q][i];
  if (i < N_COST) {
    part[static_cast<size_t>(c) * N_COST + i] = sum;
  } else if (i < N_COST + 45) {
    int p, j;
    tri9(i - N_COST, p, j);
    const float h = static_cast<float>(sum);
    hcc[static_cast<size_t>(c) * 81 + 9 * p + j] = h;
    hcc[static_cast<size_t>(c) * 81 + 9 * j + p] = h;
  } else {
    bc[static_cast<size_t>(c) * 9 + (i - N_COST - 45)] =
        -static_cast<float>(sum);
  }
}

// The cost and the rows kept: the cameras' float64 partials summed camera
// by camera (thread t takes every SUM_THREADS-th camera from t, then a
// fixed tree), rounded once.
__global__ void __launch_bounds__(SUM_THREADS)
bal_total_kernel(const double* __restrict__ part, int C,
                 float* __restrict__ cost, int* __restrict__ n_kept) {
  __shared__ double red[SUM_WARPS][N_COST];
  double acc[N_COST] = {0.0, 0.0};
  for (int c = threadIdx.x; c < C; c += SUM_THREADS) {
#pragma unroll
    for (int i = 0; i < N_COST; ++i)
      acc[i] += part[static_cast<size_t>(c) * N_COST + i];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
    for (int i = 0; i < N_COST; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], d);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < N_COST; ++i) red[warp][i] = acc[i];
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double s[N_COST];
#pragma unroll
  for (int i = 0; i < N_COST; ++i) {
    s[i] = red[0][i];
#pragma unroll
    for (int q = 1; q < SUM_WARPS; ++q) s[i] += red[q][i];
  }
  *cost = static_cast<float>(s[0]);
  if (n_kept != nullptr) *n_kept = static_cast<int>(s[1]);
}

__global__ void __launch_bounds__(LM_THREADS)
bal_landmarks_kernel(BalArgs a, float* __restrict__ hll,
                     float* __restrict__ bl) {
  const int l = blockIdx.x * LM_THREADS + threadIdx.x;
  if (l >= a.n_lms) return;
  double h[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double g[3] = {0.0, 0.0, 0.0};
  const int beg = __ldg(a.lm_off + l);
  const int end = __ldg(a.lm_off + l + 1);
  if (beg < end) {
    float X[3];
    load_point(a.points, l, X);
    for (int q = beg; q < end; ++q) {
      const int o = __ldg(a.lm_rows + q);
      const Cam9 k = load_cam(a.cams, __ldg(a.lm_cams + q));
      const Obs s = observe(a, k, X, o);
      float A[6], Jl[6];
      point_jacobian(k, s, A);
      landmark_jacobian(A, k.R, Jl);
      const float rw[2] = {s.r[0] * s.wt, s.r[1] * s.wt};
      int n = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = i; j < 3; ++j) {
          float m = Jl[i] * Jl[j];
          m = m + Jl[3 + i] * Jl[3 + j];
          h[n++] += static_cast<double>(m * s.wt);
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float m = Jl[i] * rw[0];
        m = m + Jl[3 + i] * rw[1];
        g[i] += static_cast<double>(m);
      }
    }
  }
  float* hl = hll + static_cast<size_t>(l) * 9;
  const int P[6] = {0, 0, 0, 1, 1, 2}, Q[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
  for (int n = 0; n < 6; ++n) {
    const float v = static_cast<float>(h[n]);
    hl[3 * P[n] + Q[n]] = v;
    hl[3 * Q[n] + P[n]] = v;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    bl[static_cast<size_t>(l) * 3 + i] = -static_cast<float>(g[i]);
}

}  // namespace

extern "C" {

// sizeof(BalArgs), which `cuda_kernels._BalArgs` must equal.
int slam_bal_obs_args_size() { return static_cast<int>(sizeof(BalArgs)); }

// W (O,9,3), hcc (C,9,9), bc (C,9); cost () at the estimate; n_kept () =
// rows whose step weight is positive; part: (C,2) float64 scratch. C >= 1.
int slam_bal_obs_cameras(const BalArgs* a, float* W, float* hcc, float* bc,
                         double* part, float* cost, int* n_kept,
                         cudaStream_t stream) {
  bal_cameras_kernel<true><<<a->n_cams + TAIL_BLOCKS, CAM_THREADS, 0,
                             stream>>>(*a, W, hcc, bc, part);
  bal_total_kernel<<<1, SUM_THREADS, 0, stream>>>(part, a->n_cams, cost,
                                                  n_kept);
  return static_cast<int>(cudaGetLastError());
}

// hll (L,3,3), bl (L,3). L >= 1.
int slam_bal_obs_landmarks(const BalArgs* a, float* hll, float* bl,
                           cudaStream_t stream) {
  const int blocks = (a->n_lms + LM_THREADS - 1) / LM_THREADS;
  bal_landmarks_kernel<<<blocks, LM_THREADS, 0, stream>>>(*a, hll, bl);
  return static_cast<int>(cudaGetLastError());
}

// cost () as slam_bal_obs_cameras gives it; part: (C,2) float64 scratch.
// C >= 1.
int slam_bal_obs_cost(const BalArgs* a, double* part, float* cost,
                      cudaStream_t stream) {
  bal_cameras_kernel<false><<<a->n_cams, CAM_THREADS, 0, stream>>>(
      *a, nullptr, nullptr, nullptr, part);
  bal_total_kernel<<<1, SUM_THREADS, 0, stream>>>(part, a->n_cams, cost,
                                                  nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
