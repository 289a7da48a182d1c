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
// Design: ragged_dp's own strip-group body. `base` is ragged_dp's kernel
// itself, launched by the wrapper through the engine's library at a G the
// caller gives. The variants run ragged_dp's frame over one block
// (unroll_kernel: a lane's strips go to G threads of one warp; each pass
// stages G strips of the profile in shared memory, sweeps them as a column
// wavefront with rows handed on by __shfl_up_sync and, between passes,
// through an int2 scratch, and merges the strips' bests by shuffle,
// sg::merge_strip) through sg::sweep, the wavefront ragged_dp runs, with
// another column body (sg::Body). All equal each other and ragged_dp:
//   hooks     - the default sg::Body: ragged_dp's column body in this
//               frame, with no variant's change (the variants' control);
//   fold2     - the score tracker folded over two cells with
//               __vimax3_s32 (best = max3(best, H[2i][t], H[2i+1][t])),
//               what the TPU's unroll2 did over two columns; rows pair up
//               inside one compiled column body, which ragged_dp shares;
//   dpx       - E and F by __viaddmax_s32, H by __vimax3_s32_relu;
//   dpx_fold2 - both;
//   r8, r32   - strip heights 8 and 32 inside the group (r32 with h
//               pinned in a register, see sg::sweep).
// What bounds it: as ragged_dp, int32 issue along each column's R-row
// chain (3.5 max-type instructions per SW x0 cell at least, on the 64-lane
// ALU pipe). Bytes: letters once per pass, scratch only between passes.

#include "../../engine/csrc/strip_group.cuh"

namespace {

using namespace sg;

struct UnrollArgs {
  const int* profile;     // [Q, W] int32
  const int8_t* letters;  // [t4, B, 4]
  const int* lengths;     // [B]
  int2* scratch;          // (H, F) of a pass's last row, [t, B]
  int* out;               // [B]
  int B, Q, W, G, go, ge;
};

template <int RR, bool FOLD, bool DPX>
__global__ void __launch_bounds__(THREADS) unroll_kernel(UnrollArgs a) {
  using V = Body<RR, DPX, FOLD>;
  extern __shared__ int sprof[];  // [G][W][RR + 1]
  const int G = a.G;
  const int g = threadIdx.x & (G - 1);
  const int lane = blockIdx.x * (THREADS / G) + threadIdx.x / G;
  const int B = a.B, Q = a.Q, W = a.W, go = a.go, ge = a.ge;
  const int len = lane < B ? a.lengths[lane] : 0;
  const int wlen = __reduce_max_sync(FULL, len);
  const int steps = wlen > 0 ? wlen + G - 1 : 0;
  const uint32_t* lw = reinterpret_cast<const uint32_t*>(a.letters) + lane;
  int2* scr = a.scratch == nullptr ? nullptr : a.scratch + lane;
  const int ns = (Q + RR - 1) / RR;
  const int passes = (ns + G - 1) / G;
  int best = 0, best_r = 0, best_c = 0, ocm = NEG, orow = 0;
  Flags fl{};  // unused: no flag rows

  for (int p = 0; p < passes; ++p) {
    stage_profile<RR>(sprof, a.profile, p * G * RR, Q, G, W);
    const int s = p * G + g;  // this thread's strip
    const bool mine = s < ns;
    const int r0 = s * RR;
    const bool last = s == ns - 1;
    const int jl = Q - 1 - r0;
    const bool put = mine && g == G - 1 && s + 1 < ns;
    const int src = g > 0 ? SRC_SHUFFLE : r0 > 0 ? SRC_SCRATCH : SRC_WALL;
    const StripOut o = sweep<MODE_SW, false, false, V>(
        sprof + g * W * (RR + 1), lw, scr, B, len, steps, G, g, mine, src,
        put, last, r0, jl, last ? jl : RR - 1, go, ge, fl);
    for (int g2 = 0; g2 < G && p * G + g2 < ns; ++g2)
      merge_strip<MODE_SW, false>(o, g2, G, best, best_r, best_c, ocm, orow);
  }
  if (lane < B && g == 0) a.out[lane] = best;
}

// dynamic shared memory of G strips of RR rows, W letters
inline size_t smem_rows(int G, int W, int RR) {
  return (size_t)G * W * (RR + 1) * sizeof(int);
}

template <int RR, bool FOLD, bool DPX>
int launch_probe(const UnrollArgs& a, cudaStream_t stream) {
  const int grid = (int)(((size_t)a.B * a.G + THREADS - 1) / THREADS);
  const int err = launch_kernel(unroll_kernel<RR, FOLD, DPX>, a, grid,
                                smem_rows(a.G, a.W, RR), stream);
  return err ? err : (int)cudaGetLastError();
}

constexpr int strip_rows(int variant) {
  return variant == 4 ? 8 : variant == 5 ? 32 : 16;
}

}  // namespace

// variant: 1 fold2, 2 dpx, 3 dpx_fold2, 4 r8, 5 r32, 6 hooks (0, base, is
// ragged_dp's own launch). G: threads per lane (1, 2, 4 or 8).
// scratch holds 2 int32 per letter byte (may be null when Q fits one
// pass, G strips of the variant's height). Returns cudaGetLastError() (0
// on success).
extern "C" int exp_unroll_launch(const void* profile, const void* letters,
                                 const void* lengths, void* scratch,
                                 void* out, int B, int Q, int W, int G,
                                 int go, int ge, int variant, void* stream) {
  if (variant < 1 || variant > 6 || B < 1 || Q < 1 || W < 1 || W > MAX_W ||
      G < 1 || G > MAX_G || (G & (G - 1)) != 0 ||
      (Q > G * strip_rows(variant) && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  UnrollArgs a{static_cast<const int*>(profile),
               static_cast<const int8_t*>(letters),
               static_cast<const int*>(lengths),
               static_cast<int2*>(scratch),
               static_cast<int*>(out),
               B, Q, W, G, go, ge};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 1: return launch_probe<16, true, false>(a, s);
    case 2: return launch_probe<16, false, true>(a, s);
    case 3: return launch_probe<16, true, true>(a, s);
    case 4: return launch_probe<8, false, false>(a, s);
    case 5: return launch_probe<32, false, false>(a, s);
    default: return launch_probe<16, false, false>(a, s);
  }
}

// out[3]: resident CUDA blocks per SM at G threads per lane and profile
// width W, registers per thread, local (spill) bytes per thread, of a
// variant as exp_unroll_launch numbers them (sg::kernel_attrs). Returns a
// cudaError_t (0 on success).
extern "C" int exp_unroll_attrs(int variant, int G, int W, int* out) {
  if (G < 1 || G > MAX_G || W < 1 || W > MAX_W)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_rows(G, W, strip_rows(variant));
  switch (variant) {
    case 1: return kernel_attrs(unroll_kernel<16, true, false>, smem, out);
    case 2: return kernel_attrs(unroll_kernel<16, false, true>, smem, out);
    case 3: return kernel_attrs(unroll_kernel<16, true, true>, smem, out);
    case 4: return kernel_attrs(unroll_kernel<8, false, false>, smem, out);
    case 5: return kernel_attrs(unroll_kernel<32, false, false>, smem, out);
    case 6: return kernel_attrs(unroll_kernel<16, false, false>, smem, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
