// FAST-9 corner score maps for Hopper (sm_90a): every pyramid level of a
// frame in one launch.
//
// Replaces: slam1_tpu/ops/pallas_kernels.py:fast_score (kernel body
// _fast_kernel), the TPU kernel that scores row strips held in VMEM.
//
// What it computes: for each pixel, the 16 taps of the radius-3
// Bresenham circle. The pixel is a corner when >= `arc` consecutive
// taps are all brighter than centre + t or all darker than centre - t
// (strict compares); its score is max over the two polarities of
// sum(max(|diff| - t, 0)), summed in circle order 0..15 (the plain
// twin's order, so the result is bit-identical and NMS keeps the same
// pixels). Pixels within 3 px of the border score 0.
//
// What bounds it on the H100: device-memory bytes. Each pixel is read
// once and written once (8 B/pixel; 2 images x 3 levels of a 376x1280
// frame is 10.1 MB, 0.0030 ms at 3.35 TB/s), against 113 float32
// operations per pixel for the score itself (0.0021 ms at the float32
// peak). Measured: 0.0136 ms of device time per frame in one launch
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W), 22 % of that bound;
// the three launches of the kernel this one replaced took 0.0385 ms
// (kernel_bench.py, same card). What holds it now is the rate at which
// the SMs issue, not bytes: without its arithmetic (tile staged, centre
// pixel written) the same launch takes 0.0044 ms, and a pixel costs
// about 175 machine operations (48 float additions for the differences
// and excesses, 32 shifts for the two masks, 18 for the two arc tests,
// 64 for the two sums), half of them on the half-rate integer pipe.
//
// Design.
//   - One launch per frame. The launcher takes up to 8 levels (input,
//     output, B, H, W each), cuts each into TW x TH tiles and numbers
//     the tiles of all levels in one range, largest level first, so the
//     big level's tiles start first and the small levels fill the tail.
//     The table travels as a kernel argument; a block finds its level
//     by scanning it. slam_fast_score is the one-level case.
//   - Taps in registers. A thread owns PPT neighbouring pixels of a row
//     and loads their 7-row window from the shared-memory tile once,
//     with PPT-wide loads at compile-time offsets from one base address;
//     the 16 tap offsets are compile-time, so every tap is a register.
//   - The arc test on bit masks. The excesses t - diff and t + diff are
//     negative exactly where a tap is brighter or darker; their sign
//     bits, shifted into a register one tap at a time, make a 16-bit
//     mask m per polarity, and the score sums the same excesses, so a
//     tap costs three additions and two shifts, no compare. With m32 = m | m << 16, a run of >= ARC set bits on
//     the circle exists iff AND_{k < ARC} (m32 >> k) has a bit among
//     0..15: four shift-and-AND steps for ARC = 9 (1 -> 2 -> 4 -> 8 ->
//     9). ARC = 9 is compiled in; any other arc in [1, 16] takes an
//     instantiation that ANDs arc - 1 shifts in a loop.
//   - The score only where there is a corner: the two sums are skipped
//     by every warp in which no lane's pixel passed the arc test
//     (__any_sync): most warps of a camera's frame, few of a frame as
//     dense in corners as the synthetic clips (15 % of the pixels).
//   - 16-byte memory operations. The tile starts 4 columns left of its
//     first pixel, on a 16-byte boundary, so a float4 of a row lies
//     wholly inside or wholly outside the image: staged with one
//     float4 load or as zeros, no test per element. A thread stores its
//     PPT scores as one vector. This needs W % 4 == 0 and 16-byte
//     aligned base pointers; the launcher decides per level, and any
//     other level (a ragged width, a misaligned contiguous view) takes
//     the scalar staging and stores of the same kernel.
//   - Tiling: 64 x 8 pixels per block, 4 pixels per thread, 128 threads,
//     registers capped at 64 so that 8 blocks fit an SM (40 bytes
//     spilled): the fastest of the tilings timed (32 x 8 x 1 to 128 x 8
//     x 4, 1 to 4 rows per thread), all within 30 % of each other.
// Build with --fmad=false: the score must round as the plain twin's.
// FAST_TW, FAST_TH, FAST_PPT, FAST_MIN_BLOCKS and FAST_COPY_ONLY may be
// set on the compiler's command line to time other tilings and the
// kernel without its arithmetic (kernel_bench.py does).

#include <cstdint>
#include <cuda_runtime.h>

#ifndef FAST_TW
#define FAST_TW 64
#endif
#ifndef FAST_TH
#define FAST_TH 8
#endif
#ifndef FAST_PPT
#define FAST_PPT 4
#endif
#ifndef FAST_COPY_ONLY
#define FAST_COPY_ONLY 0  // timing: 1 writes the centre pixel, 2 a sum of taps
#endif
#ifndef FAST_MIN_BLOCKS
#define FAST_MIN_BLOCKS 8  // blocks per SM the register count must allow
#endif

namespace {

constexpr int TW = FAST_TW;    // tile width in pixels
constexpr int TH = FAST_TH;    // tile height
constexpr int PPT = FAST_PPT;  // neighbouring pixels of a row per thread
constexpr int R = 3;           // circle radius == border width
constexpr int HALO_X = 4;      // columns staged left and right of the tile
constexpr int SW = TW + 2 * HALO_X;  // floats per staged row
constexpr int SH = TH + 2 * R;       // staged rows
constexpr int THREADS = (TW / PPT) * TH;
constexpr int WIN = PPT + 2 * HALO_X;  // columns of a thread's window
constexpr int MAX_LEVELS = 8;

static_assert(PPT == 1 || PPT == 2 || PPT == 4, "PPT is a vector width");
static_assert(TW % 4 == 0 && TW % PPT == 0, "tile rows are whole vectors");
static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps");

struct Level {
  const float* img;
  float* out;
  int B, H, W;
  int tiles_x, tiles_y;
  int first_tile;  // index of this level's first tile in the launch
  int vec;         // 16-byte loads and vector stores are safe
};

struct LevelTable {
  Level lv[MAX_LEVELS];
  int n;
};

// The circle, tap k at (dy, dx), in circular order.
#define FAST_TAPS(T)                                                        \
  T(0, -3, 0) T(1, -3, 1) T(2, -2, 2) T(3, -1, 3) T(4, 0, 3) T(5, 1, 3)     \
  T(6, 2, 2) T(7, 3, 1) T(8, 3, 0) T(9, 3, -1) T(10, 2, -2) T(11, 1, -3)    \
  T(12, 0, -3) T(13, -1, -3) T(14, -2, -2) T(15, -3, -1)

// Bit i (i < 16) of the result: taps i .. i + arc - 1 (mod 16) of the
// 16-bit circular mask m are all set. Bits 16..31 mean nothing.
// ARC > 0: arc is that constant; ARC == 0: arc is the argument.
template <int ARC>
__device__ __forceinline__ uint32_t run_starts(uint32_t m, int arc) {
  const uint32_t m32 = m * 0x10001u;  // m | m << 16
  uint32_t r = m32;
  if (ARC > 0) {
    int have = 1;  // bit i of r: bits i .. i + have - 1 of m32 are set
#pragma unroll
    for (; 2 * have <= ARC; have *= 2) r &= r >> have;
    if (have < ARC) r &= r >> (ARC - have);
  } else {
    for (int k = 1; k < arc; ++k) r &= m32 >> k;
  }
  return r;
}

// N (1, 2 or 4) floats from an N-float-aligned shared-memory address.
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x;
    dst[N > 1 ? 1 : 0] = v.y;
    dst[N > 2 ? 2 : 0] = v.z;
    dst[N > 3 ? 3 : 0] = v.w;
  } else if (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x;
    dst[N > 1 ? 1 : 0] = v.y;
  } else {
    dst[0] = src[0];
  }
}

template <int ARC>
__global__ void __launch_bounds__(THREADS, FAST_MIN_BLOCKS)
fast_score_kernel(const __grid_constant__ LevelTable tab, float thr,
                  int arc) {
  __shared__ __align__(16) float tile[SH * SW];

  // Which level, which tile of it.
  const int bid = blockIdx.x;
  int l = 0;
  for (int i = 1; i < tab.n; ++i) {
    if (bid >= tab.lv[i].first_tile) l = i;
  }
  const Level& L = tab.lv[l];
  const int H = L.H, W = L.W;
  const bool vec = L.vec != 0;
  int t = bid - L.first_tile;
  const int tile_x = t % L.tiles_x;
  t /= L.tiles_x;
  const int tile_y = t % L.tiles_y;
  const size_t image = static_cast<size_t>(t / L.tiles_y) * H * W;
  const float* __restrict__ src = L.img + image;
  float* __restrict__ dst = L.out + image;
  const int x0 = tile_x * TW;
  const int y0 = tile_y * TH;
  const int tid = threadIdx.x;

  // Stage rows y0 - 3 .. y0 + TH + 2, columns x0 - 4 .. x0 + TW + 3, zeros
  // outside the image (they only feed border pixels, which score 0). SW
  // is a compile-time divisor.
  if (vec) {
    for (int i = tid; i < SH * (SW / 4); i += THREADS) {
      const int ly = i / (SW / 4);
      const int gy = y0 + ly - R;
      const int gx = x0 + 4 * (i - ly * (SW / 4)) - HALO_X;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        v = __ldg(reinterpret_cast<const float4*>(src + (gy * W + gx)));
      }
      reinterpret_cast<float4*>(tile)[i] = v;
    }
  } else {
    for (int i = tid; i < SH * SW; i += THREADS) {
      const int ly = i / SW;
      const int gy = y0 + ly - R;
      const int gx = x0 + (i - ly * SW) - HALO_X;
      tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                    ? __ldg(src + (gy * W + gx))
                    : 0.0f;
    }
  }
  __syncthreads();

  // This thread's PPT pixels (x .. x + PPT - 1, y) and their window:
  // rows y - 3 .. y + 3, columns x - 4 .. x + PPT + 3, in registers.
  // Loads the taps do not need are dropped by the compiler.
  const int tx = tid % (TW / PPT);
  const int ty = tid / (TW / PPT);
  const int x = x0 + tx * PPT;
  const int y = y0 + ty;
  float w[2 * R + 1][WIN];
  const float* base = tile + ty * SW + tx * PPT;
#pragma unroll
  for (int r = 0; r < 2 * R + 1; ++r) {
#pragma unroll
    for (int v = 0; v < WIN / PPT; ++v) {
      load_vec<PPT>(&w[r][v * PPT], base + r * SW + v * PPT);
    }
  }

  const bool row_inside = y >= R && y < H - R;
  float score[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const float c = w[R][HALO_X + p];
    if (FAST_COPY_ONLY == 1) {
      score[p] = c;
      continue;
    }
    // Per tap: over = t - diff is negative iff diff > t (brighter), under
    // = t + diff is negative iff diff < -t (darker), exactly: a float
    // difference is 0 only between equal numbers, and then +0 (t is not
    // -0: the launcher sees to it). Their sign bits are shifted into
    // the masks, tap 0 ending highest: a mirrored circle has the same
    // runs. The excesses the score sums are the same numbers negated:
    // diff - t == -over and -diff - t == -under, to the bit.
    float over[16], under[16];
    uint32_t bright = 0, dark = 0;
#define FAST_MASK(k, dy, dx)                                             \
  {                                                                      \
    const float diff = w[R + (dy)][HALO_X + p + (dx)] - c;               \
    over[k] = thr - diff;                                                \
    under[k] = thr + diff;                                               \
    bright = __funnelshift_l(__float_as_uint(over[k]), bright, 1);       \
    dark = __funnelshift_l(__float_as_uint(under[k]), dark, 1);          \
  }
    FAST_TAPS(FAST_MASK)
#undef FAST_MASK
    if (FAST_COPY_ONLY == 2) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) sum += over[k];
      score[p] = sum;
      continue;
    }
    const bool corner =
        row_inside && x + p >= R && x + p < W - R &&
        ((run_starts<ARC>(bright, arc) | run_starts<ARC>(dark, arc)) &
         0xffffu) != 0;
    score[p] = 0.0f;
    // Every thread of the warp reaches the vote: none has left early.
    if (__any_sync(0xffffffffu, corner)) {
      float score_b = 0.0f, score_d = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        score_b = score_b + fmaxf(-over[k], 0.0f);
        score_d = score_d + fmaxf(-under[k], 0.0f);
      }
      score[p] = corner ? fmaxf(score_b, score_d) : 0.0f;
    }
  }

  if (y >= H) return;
  float* row = dst + y * W;
  if (vec) {
    // W % 4 == 0 and x % PPT == 0: the PPT pixels are all inside or all
    // outside, and the store is aligned.
    if (x < W) {
      if (PPT == 4) {
        *reinterpret_cast<float4*>(row + x) =
            make_float4(score[0], score[PPT > 1 ? 1 : 0],
                        score[PPT > 2 ? 2 : 0], score[PPT > 3 ? 3 : 0]);
      } else if (PPT == 2) {
        *reinterpret_cast<float2*>(row + x) =
            make_float2(score[0], score[PPT > 1 ? 1 : 0]);
      } else {
        row[x] = score[0];
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      if (x + p < W) row[x + p] = score[p];
    }
  }
}

}  // namespace

// One level as the caller states it: img, out (B, H, W) float32,
// contiguous, on the current device.
struct FastLevelArg {
  const float* img;
  float* out;
  int B, H, W;
};

extern "C" int slam_fast_score_max_levels() { return MAX_LEVELS; }

// Scores n_levels (1..8) images in one launch. Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int slam_fast_score_levels(const FastLevelArg* levels,
                                      int n_levels, float threshold, int arc,
                                      void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || arc < 1 || arc > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  threshold += 0.0f;  // -0 becomes +0: the kernel reads signs
  // Largest level first (a stable insertion sort of at most 8 indices).
  int order[MAX_LEVELS];
  for (int i = 0; i < n_levels; ++i) {
    const FastLevelArg& a = levels[i];
    // One image's pixels are indexed with an int.
    if (a.B < 1 || a.H < 1 || a.W < 1 || 1LL * a.H * a.W > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long px = 1LL * a.B * a.H * a.W;
    int j = i;
    for (; j > 0; --j) {
      const FastLevelArg& o = levels[order[j - 1]];
      if (1LL * o.B * o.H * o.W >= px) break;
      order[j] = order[j - 1];
    }
    order[j] = i;
  }
  LevelTable tab;
  tab.n = n_levels;
  long long total = 0;
  for (int i = 0; i < n_levels; ++i) {
    const FastLevelArg& a = levels[order[i]];
    Level& lv = tab.lv[i];
    lv.img = a.img;
    lv.out = a.out;
    lv.B = a.B;
    lv.H = a.H;
    lv.W = a.W;
    lv.tiles_x = (a.W + TW - 1) / TW;
    lv.tiles_y = (a.H + TH - 1) / TH;
    lv.first_tile = static_cast<int>(total);
    lv.vec = a.W % 4 == 0 && reinterpret_cast<uintptr_t>(a.img) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
    total += 1LL * lv.tiles_x * lv.tiles_y * a.B;
    if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(total);
  if (arc == 9) {
    fast_score_kernel<9><<<grid, THREADS, 0, st>>>(tab, threshold, arc);
  } else {
    fast_score_kernel<0><<<grid, THREADS, 0, st>>>(tab, threshold, arc);
  }
  return static_cast<int>(cudaGetLastError());
}

// The one-level case: img, out (B, H, W).
extern "C" int slam_fast_score(const float* img, float* out, int B, int H,
                               int W, float threshold, int arc,
                               void* stream) {
  const FastLevelArg one = {img, out, B, H, W};
  return slam_fast_score_levels(&one, 1, threshold, arc, stream);
}
