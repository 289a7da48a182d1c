// exp_unroll: ablations of ragged_dp's column body, SW score only.
//
// Replaces opal_tpu's TPU probe tools/exp_unroll.py: build (:32-135,
// pallas_call :127), which times the SW score-only column loop at 1, 2, 4
// and 8 columns per state write (its `unroll` variants; the running max
// folded as m = max(m, max(H1, H2))). It computes that probe's function:
// per lane, the best SW score (gap open go, extend ge) of the query
// profile against the lane's letters. The TPU mechanics (ramped rows, the
// one-hot profile matmul, the roll-based scan, VMEM round trips) have no
// counterpart; the knobs become the ones this card has. The input is
// ragged_dp's: a profile [Q, W] int32 and one block of the kernels.Stream
// layout ([t4, B, 4] int8 letters, lengths [B]), so the same input runs
// through ragged_dp and its plain version.
//
// Variants, one template each (all equal to each other and to ragged_dp):
//   base      - ragged_dp's SW x0 strip body as it is (R = 16 rows);
//   fold2     - the score tracker folded over two columns with
//               __vimax3_s32 (best = max3(best, H[t-1], H[t])): what the
//               TPU's unroll2 did;
//   dpx       - E and F by __viaddmax_s32, H by __vimax3_s32_relu;
//   dpx_fold2 - both;
//   r8, r32   - base at strip heights 8 and 32 (r32 with h pinned, see
//               the kernel).
// What bounds it: as ragged_dp, int32 issue (11 instructions per cell in
// base, 7 of them max-type; dpx needs 6, 4 max-type; the fold saves half a
// max per cell). Bytes: letters once per strip, 16 / R scratch bytes per
// cell.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_W = 128;

struct Args {
  const int* profile;     // [Q, W] int32
  const int8_t* letters;  // [t4, B, 4]
  const int* lengths;     // [B]
  int2* scratch;          // (H, F) of a strip's last row, [t, B]
  int* out;               // [B]
  int B, Q, W, go, ge;
};

constexpr int PAD_NEG = -(1 << 20);

template <int R, bool FOLD, bool DPX>
__global__ void __launch_bounds__(THREADS) unroll_kernel(Args a) {
  constexpr int RS = R + 1;  // odd shared-memory stride per letter
  __shared__ int sprof[MAX_W * RS];
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  const int B = a.B, Q = a.Q, W = a.W, go = a.go, ge = a.ge;
  const int len = lane < B ? a.lengths[lane] : 0;
  const uint32_t* lw = reinterpret_cast<const uint32_t*>(a.letters) + lane;
  int2* scr = a.scratch == nullptr ? nullptr : a.scratch + lane;
  const int ns = (Q + R - 1) / R;
  int best = 0;

  for (int s = 0; s < ns; ++s) {
    const int r0 = s * R;
    __syncthreads();
    for (int i = threadIdx.x; i < W * R; i += THREADS) {
      const int c = i / R, j = i - c * R;
      sprof[c * RS + j] = r0 + j < Q ? a.profile[(r0 + j) * W + c] : PAD_NEG;
    }
    __syncthreads();
    if (len == 0) continue;
    const bool last = s == ns - 1;

    int H[R], E[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      H[j] = 0;
      E[j] = 0;
    }
    int ul = 0;  // H[r0-1][t-1]: 0 at column 0 (SW)

    for (int t4 = 0; t4 < len; t4 += 4) {
      const uint32_t w = __ldg(lw + (size_t)(t4 >> 2) * B);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t4 + k;
        if (t >= len) break;
        const int* pr = sprof + ((w >> (8 * k)) & 0x7f) * RS;
        int hu = 0, fu = 0;  // row -1 of SW
        if (s > 0) {
          const int2 b = scr[(size_t)t * B];
          hu = b.x;
          fu = b.y;
        }
        int diag = ul;
        ul = hu;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          int e, f, h;
          const int d = diag + pr[j];
          if (DPX) {
            e = __viaddmax_s32(E[j], -ge, H[j] - go);
            f = __viaddmax_s32(fu, -ge, hu - go);
            h = __vimax3_s32_relu(e, f, d);
          } else {
            e = max(H[j] - go, E[j] - ge);
            f = max(hu - go, fu - ge);
            h = max(max(max(e, f), d), 0);
          }
          // Above 16 rows this fully unrolled body compiles wrong with
          // nvcc 12.8 for sm_90a: at R = 24 and 32 the SW best comes out 1
          // too high on lanes whose strip holds 24 or more padding rows,
          // where the same source at R <= 16, or with the row loop unrolled
          // by 8, gives the exact result. Pinning h in a register (an empty
          // asm) makes it exact; R <= 16, ragged_dp's height, gets no pin.
          if (R > 16) asm volatile("" : "+r"(h));
          // fold: odd columns take the max of this column and the one
          // before (H[j] still holds it); even columns track nothing
          if (!FOLD) {
            best = max(best, h);
          } else if (k & 1) {
            best = __vimax3_s32(best, H[j], h);
          }
          diag = H[j];
          H[j] = h;
          E[j] = e;
          hu = h;
          fu = f;
        }
        if (!last) scr[(size_t)t * B] = make_int2(hu, fu);
      }
    }
    if (FOLD && (len & 1)) {  // column len-1 is even: not folded yet
#pragma unroll
      for (int j = 0; j < R; ++j) best = max(best, H[j]);
    }
  }
  if (lane < B) a.out[lane] = best;
}

template <int R, bool FOLD, bool DPX>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned grid = (unsigned)((a.B + THREADS - 1) / THREADS);
  unroll_kernel<R, FOLD, DPX><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R, bool FOLD, bool DPX>
int occupancy() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, unroll_kernel<R, FOLD, DPX>, THREADS, 0);
  return err == cudaSuccess ? n : -(int)err;
}

}  // namespace

// variant: 0 base, 1 fold2, 2 dpx, 3 dpx_fold2, 4 r8, 5 r32.
// scratch holds 2 int32 per letter byte (may be null when Q <= the
// variant's strip height). Returns cudaGetLastError() (0 on success).
extern "C" int exp_unroll_launch(const void* profile, const void* letters,
                                 const void* lengths, void* scratch,
                                 void* out, int B, int Q, int W, int go,
                                 int ge, int variant, void* stream) {
  const int R = variant == 4 ? 8 : variant == 5 ? 32 : 16;
  if (B < 1 || Q < 1 || W < 1 || W > MAX_W ||
      (Q > R && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(profile),
         static_cast<const int8_t*>(letters),
         static_cast<const int*>(lengths),
         static_cast<int2*>(scratch),
         static_cast<int*>(out),
         B, Q, W, go, ge};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<16, false, false>(a, s);
    case 1: return launch<16, true, false>(a, s);
    case 2: return launch<16, false, true>(a, s);
    case 3: return launch<16, true, true>(a, s);
    case 4: return launch<8, false, false>(a, s);
    case 5: return launch<32, false, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Resident CUDA blocks per SM of a variant (negative: a CUDA error).
extern "C" int exp_unroll_occupancy(int variant) {
  switch (variant) {
    case 0: return occupancy<16, false, false>();
    case 1: return occupancy<16, true, false>();
    case 2: return occupancy<16, false, true>();
    case 3: return occupancy<16, true, true>();
    case 4: return occupancy<8, false, false>();
    case 5: return occupancy<32, false, false>();
    default: return -(int)cudaErrorInvalidValue;
  }
}
