// roofline: two probes of the card's own rates, for sizing ragged_dp.
//
// peak replaces opal_tpu's TPU microbenchmark tools/roofline.py:
// build_peak_kernel (:62-104, pallas_call :97). It computes that kernel's
// function: per element, 8 chains st[j] = max(st[j] + c_j, st[(j+1) % 8]) -
// c_j, updated in the order j = 0..7, UNROLL times per iteration, `iters`
// iterations (the TPU's K per grid step times G steps; the state carries
// over). The TPU kept 8 [R, B] arrays in VMEM; here one thread holds one
// element's 8 chains in registers and the whole final state is written
// back, so a check can see every chain. Four forms of the same update:
//   F32  - the TPU function as it is: add, max, sub in float;
//   I32  - the same in int32;
//   DPX  - __viaddmax_s32(st, c, next), then a sub;
//   MAX3 - __vimax3_s32(st + c, next, lo), then a sub; lo is a kernel
//          argument below every value, so the third operand never wins
//          and the compiler cannot drop it.
// The int forms run on values scaled by 8 (init 8 + 2j, c_j = 8 + j) and
// then equal 8 x the f32 state exactly. The constants arrive as kernel
// arguments, so nothing folds at compile time; nvcc still rewrites
// max(a + c, b) - c as max(a, b - c), one VIADDMNMX, in the i32 and DPX
// forms (signed overflow is undefined), which is why the tool counts the
// instructions of each built loop with cuobjdump instead of trusting this
// source.
// What bounds it: issue of the update's instructions on their pipes; the
// bytes (32 per element, read and written once) are nothing beside them.
//
// scan replaces build_scan_kernel (:107-148, pallas_call :141), the price
// of the DP's F chain, which the TPU ran as a Hillis-Steele max-plus scan
// over the rows. Per column tt (0..tc-1, in each of g steps): X[0] = -3,
// X[r] = H[r-1] - 2 (H before this column), F = the running max of X down
// the rows, H[r] = max(H[r], F[r] - tt). One thread walks one lane's QP
// rows in order, holding H in registers: ragged_dp's own method for its F
// chain (one dependent max per row). Above 64 rows H no longer fits in
// registers (ptxas spills at 80), so the rows go in two strips of QP / 2,
// as ragged_dp's strips: the first strip walks every column and leaves its
// last row's H (before the column) and running max per column in scratch
// for the second. What bounds it: the serial chain of maxes per lane,
// hidden only by other warps; the scratch adds 16 bytes per column and
// lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int CHAINS = 8;

enum { V_F32 = 0, V_I32 = 1, V_DPX = 2, V_MAX3 = 3 };

struct Consts {
  float f[CHAINS];
  int i[CHAINS];
  int lo;  // MAX3's third operand
};

template <int V, int UNROLL, typename T>
__global__ void __launch_bounds__(THREADS)
    peak_kernel(T* st, long long n, int iters, Consts c) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  T s[CHAINS];
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s[j] = st[j * n + e];
  // one iteration per trip, so the loop's SASS is UNROLL x 8 updates
#pragma unroll 1
  for (int k = 0; k < iters; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < CHAINS; ++j) {
        const int nx = (j + 1) % CHAINS;
        if constexpr (V == V_F32) {
          s[j] = fmaxf(s[j] + c.f[j], s[nx]) - c.f[j];
        } else if constexpr (V == V_I32) {
          s[j] = max(s[j] + c.i[j], s[nx]) - c.i[j];
        } else if constexpr (V == V_DPX) {
          s[j] = __viaddmax_s32(s[j], c.i[j], s[nx]) - c.i[j];
        } else {
          s[j] = __vimax3_s32(s[j] + c.i[j], s[nx], c.lo) - c.i[j];
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) st[j * n + e] = s[j];
}

template <int V, typename T>
int launch_peak(T* st, long long n, int iters, int unroll, const Consts& c,
                cudaStream_t stream) {
  const unsigned grid = (unsigned)((n + THREADS - 1) / THREADS);
  switch (unroll) {
    case 1: peak_kernel<V, 1, T><<<grid, THREADS, 0, stream>>>(st, n, iters, c); break;
    case 2: peak_kernel<V, 2, T><<<grid, THREADS, 0, stream>>>(st, n, iters, c); break;
    case 4: peak_kernel<V, 4, T><<<grid, THREADS, 0, stream>>>(st, n, iters, c); break;
    case 8: peak_kernel<V, 8, T><<<grid, THREADS, 0, stream>>>(st, n, iters, c); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int QP, int SR>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(int* H, int2* scratch, int B, int tc, int g) {
  constexpr int NS = QP / SR;  // strips of SR rows
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= B) return;
  int2* scr = scratch + lane;  // [column, lane]
  for (int s = 0; s < NS; ++s) {
    int h[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) h[r] = H[(size_t)(s * SR + r) * B + lane];
    size_t col = 0;
    for (int step = 0; step < g; ++step) {
      // one column per trip, so the loop's SASS is one column of SR rows
#pragma unroll 1
      for (int tt = 0; tt < tc; ++tt, ++col) {
        int run = -3;  // X[0]
        if (s > 0) {   // the running max and H (before this column) above
          const int2 b = scr[col * B];
          run = max(b.y, b.x - 2);
        }
        int prev = h[0];  // H[r-1] before this column
        h[0] = max(h[0], run - tt);
#pragma unroll
        for (int r = 1; r < SR; ++r) {
          run = max(run, prev - 2);
          prev = h[r];
          h[r] = max(h[r], run - tt);
        }
        if (s < NS - 1) scr[col * B] = make_int2(prev, run);
      }
    }
#pragma unroll
    for (int r = 0; r < SR; ++r) H[(size_t)(s * SR + r) * B + lane] = h[r];
  }
}

}  // namespace

// st: [8, n] (float for variant 0, int32 otherwise), updated in place.
// cf / ci: the 8 constants of each form; lo: MAX3's third operand.
// unroll: 1, 2, 4 or 8. Returns cudaGetLastError() (0 on success).
extern "C" int roofline_peak_launch(void* st, long long n, int iters,
                                    int unroll, int variant, const float* cf,
                                    const int* ci, int lo, void* stream) {
  if (n < 1 || iters < 0) return (int)cudaErrorInvalidValue;
  Consts c;
  for (int j = 0; j < CHAINS; ++j) {
    c.f[j] = cf[j];
    c.i[j] = ci[j];
  }
  c.lo = lo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case V_F32: return launch_peak<V_F32>(static_cast<float*>(st), n, iters, unroll, c, s);
    case V_I32: return launch_peak<V_I32>(static_cast<int*>(st), n, iters, unroll, c, s);
    case V_DPX: return launch_peak<V_DPX>(static_cast<int*>(st), n, iters, unroll, c, s);
    case V_MAX3: return launch_peak<V_MAX3>(static_cast<int*>(st), n, iters, unroll, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// H: [qp, B] int32, updated in place over g steps of tc columns. qp is a
// multiple of 16 up to 128; above 64 rows scratch holds one int2 per column
// and lane (tc * g * B). Returns cudaGetLastError().
extern "C" int roofline_scan_launch(void* H, void* scratch, int qp, int B,
                                    int tc, int g, void* stream) {
  if (B < 1 || tc < 0 || g < 0 || (qp > 64 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  int* h = static_cast<int*>(H);
  int2* scr = static_cast<int2*>(scratch);
  const unsigned grid = (unsigned)((B + THREADS - 1) / THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qp) {
    case 16: scan_kernel<16, 16><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    case 32: scan_kernel<32, 32><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    case 48: scan_kernel<48, 48><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    case 64: scan_kernel<64, 64><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    case 80: scan_kernel<80, 40><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    case 96: scan_kernel<96, 48><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    case 112: scan_kernel<112, 56><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    case 128: scan_kernel<128, 64><<<grid, THREADS, 0, s>>>(h, scr, B, tc, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
