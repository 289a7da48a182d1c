// exp_sstack: S database lanes interleaved in one thread, SW score only.
//
// Replaces opal_tpu's TPU ablation tools/exp_sstack_ablate.py:
// build_variant (:61-191, pallas_call :182). There S database chunk
// streams were stacked as row segments of one tall DP column, with one
// output per segment, to ask whether a short query underfills the column.
// The card's dual of that question: one thread carries S database lanes
// interleaved (S independent dependence chains, S-fold instruction-level
// parallelism) for S times fewer threads. The function is the TPU
// variant `full`'s: per lane, the running SW best (gap open go, extend
// ge) of one query profile against the lane's letters, never reset, and
// written at each chunk c (64 columns) whose meta[5 * blk + 2][c] is 1 into
// out[blk, meta[5 * blk][c], lane], where blk is the lane's stream block.
//
// Input: the profile [Q, W] int32 and a kernels.Stream of NB blocks of B
// lanes, every lane T columns long (T a multiple of 64); the thread of lane
// l in CUDA block (x, y) carries lane l of the blocks y * S .. y * S + S-1.
// Rows are swept in strips of R as in ragged_dp; a strip's running best is
// written at each emit for strip 0 and max-merged into it by later strips,
// which gives the best over all rows at that chunk. Variants (templates):
//   full   - S = 1, 2 or 4;
//   noprof - the profile read from shared memory replaced by a per-row
//            constant (the strip's letter-0 column, held in registers):
//            the function of full on letters that are all 0; it prices the
//            profile lookup.
// What bounds it: int32 issue, as ragged_dp (11 instructions per cell);
// the question is how much latency S interleaved lanes hide per thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int MAX_W = 128;
constexpr int TC = 64;  // columns per chunk (the TPU's T_CHUNK)

struct Args {
  const int* profile;     // [Q, W] int32
  const int8_t* letters;  // NB blocks of [T/4, B, 4]
  const int* meta;        // [5 * NB, C] int32
  int2* scratch;          // (H, F) of a strip's last row, [NB, T, B]
  int* out;               // [NB, nb, B]
  int B, Q, W, T, nb, go, ge;
};

template <int S, int R, bool NOPROF>
__global__ void __launch_bounds__(THREADS) sstack_kernel(Args a) {
  constexpr int RS = R + 1;
  __shared__ int sprof[MAX_W * RS];
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  const int B = a.B, Q = a.Q, W = a.W, T = a.T, go = a.go, ge = a.ge;
  const int C = T / TC;
  const int blk0 = blockIdx.y * S;
  const bool live = lane < B;
  const size_t bstride = (size_t)T * B;  // letters bytes / scratch cells per block
  const int ns = (Q + R - 1) / R;

  for (int st = 0; st < ns; ++st) {
    const int r0 = st * R;
    const bool last = st == ns - 1;
    __syncthreads();
    for (int i = threadIdx.x; i < W * R; i += THREADS) {
      const int c = i / R, j = i - c * R;
      sprof[c * RS + j] = r0 + j < Q ? a.profile[(r0 + j) * W + c]
                                     : -(1 << 20);
    }
    __syncthreads();
    if (!live) continue;
    int pc[NOPROF ? R : 1];  // noprof: the letter-0 column of this strip
    if constexpr (NOPROF) {
#pragma unroll
      for (int j = 0; j < R; ++j) pc[j] = sprof[j];
    }

    int H[S][R], E[S][R], ul[S], best[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ul[s] = 0;
      best[s] = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        H[s][j] = 0;
        E[s][j] = 0;
      }
    }

    for (int t4 = 0; t4 < T; t4 += 4) {
      uint32_t w[S];
#pragma unroll
      for (int s = 0; s < S; ++s)
        w[s] = NOPROF ? 0u
                      : __ldg(reinterpret_cast<const uint32_t*>(
                                  a.letters + (blk0 + s) * bstride) +
                              (size_t)(t4 >> 2) * B + lane);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t4 + k;
        int hu[S], fu[S], diag[S];
        const int* pr[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          pr[s] = sprof + ((w[s] >> (8 * k)) & 0x7f) * RS;
          hu[s] = 0;
          fu[s] = 0;
          if (st > 0) {
            const int2 b =
                a.scratch[(blk0 + s) * bstride + (size_t)t * B + lane];
            hu[s] = b.x;
            fu[s] = b.y;
          }
          diag[s] = ul[s];
          ul[s] = hu[s];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int e = max(H[s][j] - go, E[s][j] - ge);
            const int f = max(hu[s] - go, fu[s] - ge);
            int pv;
            if constexpr (NOPROF) {
              pv = pc[j];
            } else {
              pv = pr[s][j];
            }
            const int d = diag[s] + pv;
            const int h = max(max(max(e, f), d), 0);
            best[s] = max(best[s], h);
            diag[s] = H[s][j];
            H[s][j] = h;
            E[s][j] = e;
            hu[s] = h;
            fu[s] = f;
          }
        }
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (!last)
            a.scratch[(blk0 + s) * bstride + (size_t)t * B + lane] =
                make_int2(hu[s], fu[s]);
        if (k == 3 && (t + 1) % TC == 0) {  // the end of chunk c
          const int c = t / TC;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const int* m = a.meta + (size_t)5 * (blk0 + s) * C;
            if (__ldg(m + 2 * C + c) == 1) {
              int* o = a.out +
                       ((size_t)(blk0 + s) * a.nb + __ldg(m + c)) * B + lane;
              *o = st == 0 ? best[s] : max(*o, best[s]);
            }
          }
        }
      }
    }
  }
}

template <int S, int R, bool NOPROF>
int launch(const Args& a, int n_blocks, cudaStream_t stream) {
  const dim3 grid((a.B + THREADS - 1) / THREADS, n_blocks / S);
  sstack_kernel<S, R, NOPROF><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// S: lanes per thread (1, 2 or 4); n_blocks a multiple of S, at most 65535
// * S. T: columns of every lane, a multiple of 64. meta [5 * n_blocks,
// T / 64] int32 with block ids in [0, nb). scratch holds 2 int32 per
// letter byte (may be null when Q <= 16). noprof: the variant above.
// Returns cudaGetLastError() (0 on success).
extern "C" int exp_sstack_launch(const void* profile, const void* letters,
                                 const void* meta, void* scratch, void* out,
                                 int n_blocks, int B, int Q, int W, int T,
                                 int nb, int go, int ge, int S, int noprof,
                                 void* stream) {
  if (B < 1 || Q < 1 || W < 1 || W > MAX_W || T < TC || T % TC != 0 ||
      nb < 1 || n_blocks < 1 || (S != 1 && S != 2 && S != 4) ||
      n_blocks % S != 0 || n_blocks / S > 65535 ||
      (Q > 16 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(profile),
         static_cast<const int8_t*>(letters),
         static_cast<const int*>(meta),
         static_cast<int2*>(scratch),
         static_cast<int*>(out),
         B, Q, W, T, nb, go, ge};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (noprof) {
    switch (S) {
      case 1: return launch<1, 16, true>(a, n_blocks, st);
      case 2: return launch<2, 16, true>(a, n_blocks, st);
      default: return launch<4, 16, true>(a, n_blocks, st);
    }
  }
  switch (S) {
    case 1: return launch<1, 16, false>(a, n_blocks, st);
    case 2: return launch<2, 16, false>(a, n_blocks, st);
    default: return launch<4, 16, false>(a, n_blocks, st);
  }
}
