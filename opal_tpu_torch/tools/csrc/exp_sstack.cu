// exp_sstack: several independent dependence chains in each thread of a
// strip group, SW score only.
//
// Replaces opal_tpu's TPU ablation tools/exp_sstack_ablate.py:
// build_variant (:61-191, pallas_call :182). There S database chunk
// streams were stacked as row segments of one tall DP column, with one
// output per segment, to ask whether a short query underfills the column.
// The card's dual of that question: how much of a column's serial R-row
// chain more independent chains per thread hide. The function is the TPU
// variant `full`'s: per lane, the running SW best (gap open go, extend ge)
// of one query profile against the lane's letters, never reset, and
// written at each chunk c (64 columns) whose meta[5 * blk + 2][c] is 1 into
// out[blk, meta[5 * blk][c], lane], where blk is the lane's stream block.
//
// Input: the profile [Q, W] int32 and a kernels.Stream of NB blocks of B
// lanes, every lane T columns long (T a multiple of 64).
//
// Design: ragged_dp's strip groups (engine/csrc/strip_group.cuh). A lane's
// 16-row strips go to G threads of one warp (G from the caller), swept as a
// column wavefront (sg::sweep, ragged_dp's wavefront, with these column
// bodies) with rows handed on by __shfl_up_sync and, between passes,
// through an int2 scratch [blk, t, lane]. Each thread
// carries several chains per step (sg::Body's CHAINS), their cells
// interleaved row by row:
//   lanes<S>  - (S = 1, 2, 4) its strip for S database lanes, lane l of
//               the blocks y * S .. y * S + S - 1 for CUDA blocks (x, y):
//               the TPU tool's stacked streams, inside the wavefront;
//   strips2   - two adjacent strips of one lane: at step k the upper strip
//               computes column k - 2g, the lower one column k - 2g - 1,
//               whose row above the same thread produced one step earlier
//               (G threads cover 2G strips per pass; the column before
//               the lower strip's first and after the upper's last score
//               against `pad`, see sg::sweep);
//   noprof    - lanes<S> with the profile lookup replaced by a per-row
//               constant (the strip's letter-0 column, held in
//               registers): the function on letters that are all 0; it
//               prices the lookup.
// Each strip's running best goes out at the chunks meta marks, by
// atomicMax (order-free) into the zeroed output, which gives the best over
// all rows at that chunk. What bounds it: int32 issue, as ragged_dp.

#include "../../engine/csrc/strip_group.cuh"

namespace {

using namespace sg;

constexpr int TC = 64;  // columns per chunk (the TPU's T_CHUNK)

struct Args {
  const int* profile;     // [Q, W] int32
  const int8_t* letters;  // NB blocks of [T/4, B, 4]
  const int* meta;        // [5 * NB, C] int32
  int2* scratch;          // (H, F) of a pass's last row, [NB, T, B]
  int* out;               // [NB, nb, B], zeroed
  int B, Q, W, T, nb, G, go, ge;
};

// A strip's running best out at the end of each chunk meta marks (chain c
// of a thread is block blk0 + c, or with STRIPS2 both chains are blk0).
template <bool STRIPS2>
struct Emit {
  const int* meta;
  int* out;
  int blk0, lane, B, C, nb;
  __device__ __forceinline__ void operator()(int c, int t, int best) const {
    if ((t & (TC - 1)) != TC - 1) return;
    const int blk = blk0 + (STRIPS2 ? 0 : c), ch = t / TC;
    const int* m = meta + (size_t)5 * blk * C;
    if (__ldg(m + 2 * C + ch) == 1)
      atomicMax(out + ((size_t)blk * nb + __ldg(m + ch)) * B + lane, best);
  }
};

template <int S, bool STRIPS2, bool NOPROF>
__global__ void __launch_bounds__(THREADS) sstack_kernel(Args a) {
  constexpr int SPT = STRIPS2 ? 2 : 1;  // strips per thread and pass
  using V = Body<R, false, false, STRIPS2 ? 2 : S, STRIPS2, NOPROF>;
  extern __shared__ int sprof[];  // [SPT * G][W][RS]
  __shared__ int pad[R];          // a letter that scores PAD_NEG (STRIPS2)
  if (threadIdx.x < R) pad[threadIdx.x] = PAD_NEG;  // read after a sync
  const int G = a.G;
  const int g = threadIdx.x & (G - 1);
  const int lane = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int B = a.B, Q = a.Q, W = a.W, T = a.T;
  const int blk0 = blockIdx.y * (STRIPS2 ? 1 : S);
  const size_t bstride = (size_t)T * B;  // letter bytes = scratch cells
  const int len = lane < B ? T : 0;
  const int wlen = __reduce_max_sync(FULL, len);
  const int steps = wlen > 0 ? wlen + SPT * G - 1 : 0;
  const uint32_t* lw =
      reinterpret_cast<const uint32_t*>(a.letters + blk0 * bstride) + lane;
  int2* scr = a.scratch == nullptr ? nullptr
                                   : a.scratch + blk0 * bstride + lane;
  const Chains x{STRIPS2 ? 0 : bstride / 4, STRIPS2 ? 0 : bstride,
                 STRIPS2 ? W * RS : 0, pad};
  const Emit<STRIPS2> emit{a.meta, a.out, blk0, lane, B, T / TC, a.nb};
  const int ns = (Q + R - 1) / R;
  const int per_pass = SPT * G;
  const int passes = (ns + per_pass - 1) / per_pass;
  Flags fl{};  // unused: no flag rows

  for (int p = 0; p < passes; ++p) {
    stage_profile(sprof, a.profile, p * per_pass * R, Q, per_pass, W);
    const int s = p * per_pass + SPT * g;  // this thread's (upper) strip
    const bool mine = s < ns;
    // the last thread's (lower) strip hands its last row to the next pass
    const bool put = mine && g == G - 1 && s + SPT < ns;
    const int src = g > 0 ? SRC_SHUFFLE : s > 0 ? SRC_SCRATCH : SRC_WALL;
    sweep<MODE_SW, false, false, V>(
        sprof + SPT * g * W * RS, lw, scr, B, len, steps, G, g, mine, src,
        put, false, s * R, 0, R - 1, a.go, a.ge, fl, x, emit);
  }
}

template <int S, bool STRIPS2, bool NOPROF>
int launch(const Args& a, int n_blocks, cudaStream_t stream) {
  const dim3 grid((unsigned)(((size_t)a.B * a.G + THREADS - 1) / THREADS),
                  STRIPS2 ? n_blocks : n_blocks / S);
  const size_t smem = smem_bytes((STRIPS2 ? 2 : 1) * a.G, a.W);
  auto k = sstack_kernel<S, STRIPS2, NOPROF>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int S, bool STRIPS2, bool NOPROF>
int attrs(int G, int W, int* out) {
  return kernel_attrs(sstack_kernel<S, STRIPS2, NOPROF>,
                      smem_bytes((STRIPS2 ? 2 : 1) * G, W), out);
}

template <bool NOPROF>
int launch_any(const Args& a, int n_blocks, cudaStream_t st, int S,
               bool strips2) {
  if (strips2) return launch<1, true, NOPROF>(a, n_blocks, st);
  switch (S) {
    case 1: return launch<1, false, NOPROF>(a, n_blocks, st);
    case 2: return launch<2, false, NOPROF>(a, n_blocks, st);
    default: return launch<4, false, NOPROF>(a, n_blocks, st);
  }
}

template <bool NOPROF>
int attrs_any(int G, int W, int* out, int S, bool strips2) {
  if (strips2) return attrs<1, true, NOPROF>(G, W, out);
  switch (S) {
    case 1: return attrs<1, false, NOPROF>(G, W, out);
    case 2: return attrs<2, false, NOPROF>(G, W, out);
    default: return attrs<4, false, NOPROF>(G, W, out);
  }
}

}  // namespace

// S: lanes per thread (1, 2 or 4; 1 with strips2); n_blocks a multiple of
// S, at most 65535 * S. strips2: two strips per thread (the variant above).
// G: threads per lane (1, 2, 4 or 8). T: columns of every lane, a multiple
// of 64. meta [5 * n_blocks, T / 64] int32 with block ids in [0, nb); out
// [n_blocks, nb, B] zeroed. scratch holds 2 int32 per letter byte (may be
// null when one pass covers Q). noprof: the variant above. Returns
// cudaGetLastError() (0 on success).
extern "C" int exp_sstack_launch(const void* profile, const void* letters,
                                 const void* meta, void* scratch, void* out,
                                 int n_blocks, int B, int Q, int W, int T,
                                 int nb, int go, int ge, int S, int strips2,
                                 int noprof, int G, void* stream) {
  const int spt = strips2 ? 2 : 1;
  if (B < 1 || Q < 1 || W < 1 || W > MAX_W || T < TC || T % TC != 0 ||
      nb < 1 || n_blocks < 1 || (S != 1 && S != 2 && S != 4) ||
      (strips2 && S != 1) || n_blocks % S != 0 || n_blocks / S > 65535 ||
      G < 1 || G > MAX_G || (G & (G - 1)) != 0 ||
      (Q > spt * G * R && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(profile),
         static_cast<const int8_t*>(letters),
         static_cast<const int*>(meta),
         static_cast<int2*>(scratch),
         static_cast<int*>(out),
         B, Q, W, T, nb, G, go, ge};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return noprof ? launch_any<true>(a, n_blocks, st, S, strips2 != 0)
                : launch_any<false>(a, n_blocks, st, S, strips2 != 0);
}

// out[3]: resident CUDA blocks per SM at G threads per lane and profile
// width W, registers per thread, local (spill) bytes per thread, of the
// variant (S, strips2, noprof) as exp_sstack_launch takes it
// (sg::kernel_attrs). Returns a cudaError_t (0 on success).
extern "C" int exp_sstack_attrs(int S, int strips2, int noprof, int G, int W,
                                int* out) {
  if ((S != 1 && S != 2 && S != 4) || G < 1 || G > MAX_G || W < 1 ||
      W > MAX_W)
    return (int)cudaErrorInvalidValue;
  return noprof ? attrs_any<true>(G, W, out, S, strips2 != 0)
                : attrs_any<false>(G, W, out, S, strips2 != 0);
}
