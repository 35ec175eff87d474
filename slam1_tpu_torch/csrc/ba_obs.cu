// The observation pass of bundle adjustment's CG path, for Hopper (sm_90a):
// per stereo observation the residual, the Huber weight, the graduated
// cut, the two robust costs, the Jacobians and the normal-equation blocks,
// each observation visited once per launch and nothing but the blocks
// written.
//
// Replaces no TPU kernel. The reference writes the pass as gathers,
// vmapped Jacobians, einsums and segment sums that XLA fuses
// (slam1_tpu/models/ba.py `_cost`, `_linearize`, `_schur_solve`); in the
// port the same einsums were cuBLAS batched products of one 3x3 or 6x3
// matrix per batch entry, gathers and float64 index_add_s, about 60% of a
// global LM iteration's device time at 2048 cameras.
//
//   slam_ba_obs_cameras    one block a camera, over the camera ordering:
//                          the costs at the estimate, the coupling block
//                          W_o = Jc^T Jl w of every row (O,6,3), and by
//                          camera Hcc = sum Jc^T Jc w (C,6,6) and bc =
//                          -sum Jc^T r w (C,6); rows the ordering leaves
//                          out get W_o = 0 (the launch's last blocks).
//   slam_ba_obs_landmarks  one thread a landmark, over the landmark
//                          ordering: Hll = sum Jl^T Jl w (L,3,3) and
//                          bl = -sum Jl^T r w (L,3), r, w and Jl worked
//                          out again from the row's camera pose (2048
//                          poses of 64 bytes stay in L2): cheaper than
//                          writing Jl (36 bytes an observation) and
//                          reading it back.
//   slam_ba_obs_cost       the cameras launch's costs alone (no Jacobian,
//                          no W), at another estimate: the cost after
//                          the step and the final cost.
//
// Per observation o of camera c and landmark l, as `ops/ba_obs.py` writes
// it (and `models/ba.py` before it): Xc = R_c^T (X_l - t_c), z = Xc_z
// clamped below at Z_MIN, r = [fx Xc_x / z + cx - u, fy Xc_y / z + cy - v,
// wr (fx (Xc_x - b) / z + cx - ur)], r2 = |r|^2, the Huber weight hw =
// 1 (r2 <= delta^2) or sqrt(delta^2 / max(r2, 1e-12)), the step's weight
// w = w_o hw [r2 < cut^2]; the full cost sum w_o hw r2 and the truncated
// sum w_o min(hw r2, cap). Jp = d[u, v, wr u_r]/dXc with a zero depth
// derivative below the clamp, Jc = [-Jp | Jp hat(Xc)], Jl = Jp R^T.
//
// Precision, as in csrc/ba_schur.cu: every observation's terms in float32
// (--fmad=false: a multiply and an add each, no fused rounding; IEEE
// division and square root), each in the order of the plain twin's
// operations on the CPU (a 3-long product sums from 0 in index order),
// so that a row's terms are the twin's bits there; the sums over a
// landmark's or a camera's observations in float64, rounded once to
// float32. No atomics: a landmark's sums run in its ordering's order in
// one thread (the order of the twin's index_add_ on the CPU), a camera's
// as per-thread partial sums (thread t takes every CAM_THREADS-th row from
// t) combined by a fixed shuffle tree and then warp by warp; the costs'
// per-camera partials (float64) are summed camera by camera in a fixed
// order by one block and rounded once. The same operands give the same
// bits on every run, and the cameras launch and the cost launch give the
// same costs to the bit at the same estimate (one loop body and one
// reduction for both), so the strict accept cost_new < cost_cur compares
// two sums taken in one order.
//
// The orderings (`cuda_kernels.schur_order`, made once an LM iteration and
// shared with the reduced-system product) leave out the observations of
// weight zero, a bucket's padding; observations beyond the cut are
// visited and add zeros.
//
// What bounds it on the H100: bytes (`utils/bounds.ba_obs_work`). The
// cameras launch reads each observation's 28 bytes (uv, ur, wr, w, its
// ordering row and landmark) and its point (12 bytes, gathered) and
// writes W (72 bytes); the landmarks launch and the cost launch read the
// 28 bytes and the pose (from L2).

#include <cuda_runtime.h>

// What every entry reads, as `cuda_kernels._ObsArgs` lays it out. All
// pointers are device pointers; cut2 and cap may be null (no cut; the
// truncated cost equals the full one).
struct ObsArgs {
  const float* poses;     // (C,4,4) T_world_cam, 16-byte aligned
  const float* points;    // (L,3)
  const float* uv;        // (O,2), 8-byte aligned
  const float* ur;        // (O,)
  const float* wr;        // (O,)
  const float* w;         // (O,) the observation's weight
  const float* fx;        // () the camera
  const float* fy;
  const float* cx;
  const float* cy;
  const float* baseline;
  const float* cut2;      // () squared graduated cut, or null
  const float* cap;       // () the truncated cost's cap, or null
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
// Blocks after the C camera blocks that zero W where the ordering leaves
// rows out (they follow the cameras' rows in cam_rows).
constexpr int TAIL_BLOCKS = 32;
constexpr float Z_MIN = 1e-3f;
constexpr float R2_MIN = 1e-12f;
// A camera's float64 sums: full cost, truncated cost, rows kept, Hcc's
// upper triangle (21), bc (6).
constexpr int N_COST = 3;
constexpr int N_TERMS = N_COST + 21 + 6;

struct Cam {
  float fx, fy, cx, cy, b;
};

__device__ __forceinline__ Cam load_cam(const ObsArgs& a) {
  return Cam{__ldg(a.fx), __ldg(a.fy), __ldg(a.cx), __ldg(a.cy),
             __ldg(a.baseline)};
}

// R (row-major) and t of pose c: the first three rows of its 4x4.
__device__ __forceinline__ void load_pose(const float* __restrict__ poses,
                                          int c, float R[9], float t[3]) {
  const float4* p = reinterpret_cast<const float4*>(poses) +
                    static_cast<size_t>(c) * 4;
  const float4 q0 = __ldg(p), q1 = __ldg(p + 1), q2 = __ldg(p + 2);
  R[0] = q0.x; R[1] = q0.y; R[2] = q0.z; t[0] = q0.w;
  R[3] = q1.x; R[4] = q1.y; R[5] = q1.z; t[1] = q1.w;
  R[6] = q2.x; R[7] = q2.y; R[8] = q2.z; t[2] = q2.w;
}

__device__ __forceinline__ void load_point(const float* __restrict__ points,
                                           int l, float X[3]) {
  const float* p = points + static_cast<size_t>(l) * 3;
  X[0] = __ldg(p); X[1] = __ldg(p + 1); X[2] = __ldg(p + 2);
}

// One observation at the estimate: Xc, the clamped depth and whether it is
// free of the clamp, r, r2, the Huber weight and the step's weight.
struct Obs {
  float Xc[3], r[3], z, r2, hw, wt;
  bool free;
};

__device__ __forceinline__ Obs observe(const ObsArgs& a, const Cam& k,
                                       const float R[9], const float t[3],
                                       const float X[3], int o, bool cut,
                                       float cut2) {
  Obs s;
  const float d[3] = {X[0] - t[0], X[1] - t[1], X[2] - t[2]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float acc = 0.0f;
    acc = acc + d[0] * R[j];
    acc = acc + d[1] * R[3 + j];
    acc = acc + d[2] * R[6 + j];
    s.Xc[j] = acc;
  }
  s.free = s.Xc[2] > Z_MIN;
  s.z = s.Xc[2] < Z_MIN ? Z_MIN : s.Xc[2];     // NaN stays NaN
  const float2 uv = __ldg(reinterpret_cast<const float2*>(a.uv) + o);
  const float wr = __ldg(a.wr + o);
  const float u = k.fx * s.Xc[0] / s.z + k.cx;
  const float v = k.fy * s.Xc[1] / s.z + k.cy;
  const float u_r = k.fx * (s.Xc[0] - k.b) / s.z + k.cx;
  s.r[0] = u - uv.x;
  s.r[1] = v - uv.y;
  s.r[2] = wr * (u_r - __ldg(a.ur + o));
  s.r2 = s.r[0] * s.r[0] + s.r[1] * s.r[1] + s.r[2] * s.r[2];
  s.hw = s.r2 <= a.delta2
             ? 1.0f
             : sqrtf(a.delta2 / (s.r2 < R2_MIN ? R2_MIN : s.r2));
  s.wt = __ldg(a.w + o) * s.hw;
  if (cut) s.wt = s.wt * (s.r2 < cut2 ? 1.0f : 0.0f);
  return s;
}

// Jp = d[u, v, wr u_r]/dXc (row-major 3x3), the depth's derivative zero
// below the clamp.
__device__ __forceinline__ void projection_jacobian(const Cam& k,
                                                    const Obs& s, float wr,
                                                    float Jp[9]) {
  const float dz = s.free ? 1.0f : 0.0f;
  const float fxz = k.fx / s.z, fyz = k.fy / s.z;
  const float iz2 = dz / (s.z * s.z);
  Jp[0] = fxz; Jp[1] = 0.0f; Jp[2] = -k.fx * s.Xc[0] * iz2;
  Jp[3] = 0.0f; Jp[4] = fyz; Jp[5] = -k.fy * s.Xc[1] * iz2;
  Jp[6] = wr * fxz; Jp[7] = 0.0f;
  Jp[8] = -wr * k.fx * (s.Xc[0] - k.b) * iz2;
}

// Jl = Jp R^T.
__device__ __forceinline__ void landmark_jacobian(const float Jp[9],
                                                  const float R[9],
                                                  float Jl[9]) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float acc = 0.0f;
      acc = acc + Jp[3 * p] * R[3 * j];
      acc = acc + Jp[3 * p + 1] * R[3 * j + 1];
      acc = acc + Jp[3 * p + 2] * R[3 * j + 2];
      Jl[3 * p + j] = acc;
    }
  }
}

// The costs of one observation into its thread's sums: the full Huber
// cost, the truncated one and whether the step keeps the row.
__device__ __forceinline__ void add_costs(const Obs& s, float pw, bool capped,
                                          float cap, double acc[N_COST]) {
  acc[0] += static_cast<double>(pw * s.hw * s.r2);
  float c = s.hw * s.r2;
  if (capped) c = c > cap ? cap : c;           // NaN stays NaN
  acc[1] += static_cast<double>(pw * c);
  acc[2] += s.wt > 0.0f ? 1.0 : 0.0;
}

__device__ __forceinline__ void store_zero_w(float* __restrict__ W, int o) {
  float2* p = reinterpret_cast<float2*>(W) + static_cast<size_t>(o) * 9;
#pragma unroll
  for (int i = 0; i < 9; ++i) p[i] = make_float2(0.0f, 0.0f);
}

// Index (i, j), i <= j, of the k-th entry of a 6x6 upper triangle, row by
// row.
__device__ __forceinline__ void tri6(int k, int& i, int& j) {
  i = 0;
  int row = 6;
  while (k >= row) {
    k -= row;
    --row;
    ++i;
  }
  j = i + k;
}

// TERMS: the cameras launch (W, Hcc, bc and the costs); otherwise the cost
// launch. Both take the same rows in the same threads and reduce them the
// same way, so their costs agree to the bit.
template <bool TERMS>
__global__ void __launch_bounds__(CAM_THREADS)
obs_cameras_kernel(ObsArgs a, float* __restrict__ W, float* __restrict__ hcc,
                   float* __restrict__ bc, double* __restrict__ part) {
  constexpr int N = TERMS ? N_TERMS : N_COST;
  const int c = blockIdx.x;
  if (TERMS && c >= a.n_cams) {
    // The rows the ordering leaves out follow every camera's rows.
    const int step = TAIL_BLOCKS * CAM_THREADS;
    for (int k = __ldg(a.cam_off + a.n_cams) + (c - a.n_cams) * CAM_THREADS +
                 threadIdx.x;
         k < a.n_obs; k += step)
      store_zero_w(W, __ldg(a.cam_rows + k));
    return;
  }
  __shared__ double red[CAM_WARPS][N];
  const Cam k = load_cam(a);
  const bool cut = a.cut2 != nullptr, capped = a.cap != nullptr;
  const float cut2 = cut ? __ldg(a.cut2) : 0.0f;
  const float cap = capped ? __ldg(a.cap) : 0.0f;
  float R[9], t[3];
  load_pose(a.poses, c, R, t);
  double acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0;
  const int beg = __ldg(a.cam_off + c);
  const int end = __ldg(a.cam_off + c + 1);
  for (int q = beg + threadIdx.x; q < end; q += CAM_THREADS) {
    const int o = __ldg(a.cam_rows + q);
    float X[3];
    load_point(a.points, __ldg(a.cam_lms + q), X);
    const Obs s = observe(a, k, R, t, X, o, cut, cut2);
    add_costs(s, __ldg(a.w + o), capped, cap, acc);
    if (TERMS) {
      float Jp[9], Jl[9], Jc[18];
      projection_jacobian(k, s, __ldg(a.wr + o), Jp);
      landmark_jacobian(Jp, R, Jl);
      // hat(Xc), row-major, as se3.hat writes it.
      const float H[9] = {0.0f, -s.Xc[2], s.Xc[1],
                          s.Xc[2], 0.0f, -s.Xc[0],
                          -s.Xc[1], s.Xc[0], 0.0f};
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          Jc[6 * p + j] = -Jp[3 * p + j];
          float m = 0.0f;
          m = m + Jp[3 * p] * H[j];
          m = m + Jp[3 * p + 1] * H[3 + j];
          m = m + Jp[3 * p + 2] * H[6 + j];
          Jc[6 * p + 3 + j] = m;
        }
      }
      float rw[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) rw[p] = s.r[p] * s.wt;
      float wo[18];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          float m = 0.0f;
          m = m + Jc[i] * Jl[j];
          m = m + Jc[6 + i] * Jl[3 + j];
          m = m + Jc[12 + i] * Jl[6 + j];
          wo[3 * i + j] = m * s.wt;
        }
      }
      // 72 bytes a row keep every row 8-byte aligned: 9 float2 stores.
      float2* dst = reinterpret_cast<float2*>(W) + static_cast<size_t>(o) * 9;
#pragma unroll
      for (int i = 0; i < 9; ++i) dst[i] = make_float2(wo[2 * i], wo[2 * i + 1]);
      int n = N_COST;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) {
          float m = 0.0f;
          m = m + Jc[i] * Jc[j];
          m = m + Jc[6 + i] * Jc[6 + j];
          m = m + Jc[12 + i] * Jc[12 + j];
          acc[n++] += static_cast<double>(m * s.wt);
        }
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float m = 0.0f;
        m = m + Jc[i] * rw[0];
        m = m + Jc[6 + i] * rw[1];
        m = m + Jc[12 + i] * rw[2];
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
  } else if (i < N_COST + 21) {
    int p, j;
    tri6(i - N_COST, p, j);
    const float h = static_cast<float>(sum);
    hcc[static_cast<size_t>(c) * 36 + 6 * p + j] = h;
    hcc[static_cast<size_t>(c) * 36 + 6 * j + p] = h;
  } else {
    bc[static_cast<size_t>(c) * 6 + (i - N_COST - 21)] =
        -static_cast<float>(sum);
  }
}

// The costs: the cameras' float64 partials summed camera by camera (thread
// t takes every SUM_THREADS-th camera from t, then a fixed tree), rounded
// once.
__global__ void __launch_bounds__(SUM_THREADS)
obs_total_kernel(const double* __restrict__ part, int C,
                 float* __restrict__ costs, int* __restrict__ n_kept) {
  __shared__ double red[SUM_WARPS][N_COST];
  double acc[N_COST] = {0.0, 0.0, 0.0};
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
  costs[0] = static_cast<float>(s[0]);
  costs[1] = static_cast<float>(s[1]);
  if (n_kept != nullptr) *n_kept = static_cast<int>(s[2]);
}

__global__ void __launch_bounds__(LM_THREADS)
obs_landmarks_kernel(ObsArgs a, float* __restrict__ hll,
                     float* __restrict__ bl) {
  const int l = blockIdx.x * LM_THREADS + threadIdx.x;
  if (l >= a.n_lms) return;
  double h[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  double g[3] = {0.0, 0.0, 0.0};
  const int beg = __ldg(a.lm_off + l);
  const int end = __ldg(a.lm_off + l + 1);
  if (beg < end) {
    const Cam k = load_cam(a);
    const bool cut = a.cut2 != nullptr;
    const float cut2 = cut ? __ldg(a.cut2) : 0.0f;
    float X[3];
    load_point(a.points, l, X);
    for (int q = beg; q < end; ++q) {
      const int o = __ldg(a.lm_rows + q);
      float R[9], t[3];
      load_pose(a.poses, __ldg(a.lm_cams + q), R, t);
      const Obs s = observe(a, k, R, t, X, o, cut, cut2);
      float Jp[9], Jl[9];
      projection_jacobian(k, s, __ldg(a.wr + o), Jp);
      landmark_jacobian(Jp, R, Jl);
      float rw[3];
#pragma unroll
      for (int p = 0; p < 3; ++p) rw[p] = s.r[p] * s.wt;
      int n = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = i; j < 3; ++j) {
          float m = 0.0f;
          m = m + Jl[i] * Jl[j];
          m = m + Jl[3 + i] * Jl[3 + j];
          m = m + Jl[6 + i] * Jl[6 + j];
          h[n++] += static_cast<double>(m * s.wt);
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float m = 0.0f;
        m = m + Jl[i] * rw[0];
        m = m + Jl[3 + i] * rw[1];
        m = m + Jl[6 + i] * rw[2];
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

// sizeof(ObsArgs), which `cuda_kernels._ObsArgs` must equal.
int slam_ba_obs_args_size() { return static_cast<int>(sizeof(ObsArgs)); }

// W (O,6,3), hcc (C,6,6), bc (C,6); costs (2,) = the full and the
// truncated cost at the estimate; n_kept () = rows whose step weight is
// positive; part: (C,3) float64 scratch. C >= 1.
int slam_ba_obs_cameras(const ObsArgs* a, float* W, float* hcc, float* bc,
                        double* part, float* costs, int* n_kept,
                        cudaStream_t stream) {
  obs_cameras_kernel<true><<<a->n_cams + TAIL_BLOCKS, CAM_THREADS, 0,
                             stream>>>(*a, W, hcc, bc, part);
  obs_total_kernel<<<1, SUM_THREADS, 0, stream>>>(part, a->n_cams, costs,
                                                  n_kept);
  return static_cast<int>(cudaGetLastError());
}

// hll (L,3,3), bl (L,3). L >= 1.
int slam_ba_obs_landmarks(const ObsArgs* a, float* hll, float* bl,
                          cudaStream_t stream) {
  const int blocks = (a->n_lms + LM_THREADS - 1) / LM_THREADS;
  obs_landmarks_kernel<<<blocks, LM_THREADS, 0, stream>>>(*a, hll, bl);
  return static_cast<int>(cudaGetLastError());
}

// costs (2,) as slam_ba_obs_cameras gives them; part: (C,3) float64
// scratch. C >= 1.
int slam_ba_obs_cost(const ObsArgs* a, double* part, float* costs,
                     cudaStream_t stream) {
  obs_cameras_kernel<false><<<a->n_cams, CAM_THREADS, 0, stream>>>(
      *a, nullptr, nullptr, nullptr, part);
  obs_total_kernel<<<1, SUM_THREADS, 0, stream>>>(part, a->n_cams, costs,
                                                  nullptr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
