// multi_dp: up to 8 queries stacked as independent row segments, scored
// against a whole resident database in one pass, affine-gap DP.
//
// Replaces opal_tpu's Pallas TPU kernel build_pallas_multi_fn_raw /
// _kernel_multi (opal_tpu/engine/pallas_kernels.py:1440-1521, body
// :1163-1437) with its host-side operand prepare_qp_multi (:1524-1545): all
// four modes (NW, HW, OV, SW) at score and score+end depth. Segment s of
// the output equals ragged_dp (csrc/ragged_dp.cu) run on query s alone,
// bit for bit; the values are final, as _kernel_multi emits them: rows
// [scores | end_qs | end_ts], NW ends (Q_s-1, len-1), HW end_q Q_s-1, OV
// ends disambiguated. None of the TPU mechanics are carried over: no
// SEG_M ramp, no f32, no max-plus scan; exact int32 and a sequential F
// chain, so every gap pair runs.
//
// Design: ragged_dp's strip groups (strip_group.cuh, and ragged_dp.cu's
// header), over the strips of the STACKED profile, each MR = 32 rows high
// (ragged_dp's are 16): the G threads of a lane's group sweep G
// consecutive stacked strips per pass, thread g - 1
// handing each column's last row to thread g by shuffle, the last thread
// of a pass to the next pass through scratch. The plan (kernels.plan_launch)
// picks G per database block from its longest lane and launches the whole
// database at once, longest block first. Every segment is padded (PAD_NEG
// rows) to whole strips on the host, so no strip spans two segments, and
// isolation is structural: a strip that starts a segment takes the wall,
// never the shuffle or scratch, wherever it falls in a pass. After each
// pass the group merges its strips' trackers in strip order into the
// current segment's (one-thread rules, as in ragged_dp); a segment's
// trackers start fresh at its first strip, and after its last strip
// thread 0 of the group writes that segment's final values.
//
// What bounds it on the H100: as for ragged_dp, integer issue along each
// column's chain, and the fill. The stacked query is tall (~75 strips of
// 32 rows for 8 queries of ~300 residues), so the longest lanes' chains
// decide the launch unless G spreads them. Strips of 32 rows halve what a
// strip costs per cell beside its DP: the scratch hand-off after every
// pass (an int2 read and write per lane and column), the profile's
// staging per pass, the G - 1 steps of lag per pass and the shuffles per
// column: a group of 8 served queries ran 22 % faster than at 16 rows on
// an H100 (PERF.md). They cost registers (SW x0: 96 a thread and 5 CUDA
// blocks an SM, against 72 at 16 rows; HW and OV ~145 and 3) and padding
// rows (a segment rounds up to 32 rows: 1-2 % more cells for 8 queries of
// 60-948 residues). Against N ragged_dp launches it saves N-1 launches and
// their tails, not DP work.

#include "strip_group.cuh"

namespace {

using namespace sg;

constexpr int MAX_SEGS = 8;    // == MULTI_MAX_SEGS
constexpr int MR = 2 * R;      // query rows per strip (== MULTI_STRIP_ROWS)
constexpr int MRS = MR + 1;    // shared-memory stride per letter (odd)

struct Args {
  const int* profile;         // [n_strips * MR, W] int32, segments stacked
  const int8_t* letters;      // blocks back to back, [t4, B, 4] each
  const long long* offsets;   // [NB + 1] byte offset of each block
  const int* lengths;         // [NB, B]
  const Job* jobs;            // [grid] the plan's CUDA blocks
  const int* groups;          // [NB] G of each block
  const long long* scr_off;   // [NB] the block's first scratch cell, or -1
  int2* scratch;              // (H, F) of a pass's last row, per cell
  int* out;                   // [NB, n_seg * (END ? 3 : 1), B]
  int B, W, go, ge, n_seg;
  int seg_q[MAX_SEGS];           // real rows of each segment
  int seg_first[MAX_SEGS + 1];   // first stacked strip of each segment
};

template <int MODE, bool END>
__global__ void __launch_bounds__(THREADS) multi_dp_kernel(Args a) {
  extern __shared__ int sprof[];  // [G][W][MRS]
  const Job job = a.jobs[blockIdx.x];
  const int blk = job.blk;
  const int G = a.groups[blk];
  const int g = threadIdx.x & (G - 1);
  const int lane = job.lane0 + threadIdx.x / G;
  const int B = a.B, W = a.W, go = a.go, ge = a.ge, n_seg = a.n_seg;
  const int len = lane < B ? a.lengths[(size_t)blk * B + lane] : 0;
  const int wlen = __reduce_max_sync(FULL, len);
  const int steps = wlen > 0 ? wlen + G - 1 : 0;
  const uint32_t* lw =
      reinterpret_cast<const uint32_t*>(a.letters + a.offsets[blk]) + lane;
  const long long so = a.scr_off[blk];
  int2* scr = so < 0 ? nullptr : a.scratch + so + lane;
  constexpr int ROWS = END ? 3 : 1;  // output rows per segment
  int* out = a.out + (size_t)blk * ROWS * n_seg * B + lane;
  const int ns = a.seg_first[n_seg];
  const int passes = (ns + G - 1) / G;
  Flags fl{};  // unused: multi_dp has no flag rows

  // the current segment's trackers, the same in every thread of the group
  int best = 0, best_r = 0, best_c = 0;  // SW
  int lr = NEG, lr_c = 0, plrm = NEG;    // HW / OV last row
  int ocm = NEG, orow = 0;               // OV last column
  int nw = NEG;                          // NW

  for (int p = 0; p < passes; ++p) {
    stage_profile<MR>(sprof, a.profile, p * G * MR, ns * MR, G, W);
    const int s = p * G + g;  // this thread's stacked strip
    const bool mine = s < ns;
    int seg = 0;
    while (seg + 1 < n_seg && a.seg_first[seg + 1] <= s) ++seg;
    const int Q = a.seg_q[seg];
    const int r0 = (s - a.seg_first[seg]) * MR;  // row within the segment
    const bool last = s == a.seg_first[seg + 1] - 1;
    const int jl = Q - 1 - r0;
    const bool put = mine && g == G - 1 && !last && s + 1 < ns;
    // a segment's first strip takes the wall, never a neighbour's row
    const int src = r0 == 0 ? SRC_WALL : g > 0 ? SRC_SHUFFLE : SRC_SCRATCH;
    const StripOut o = sweep<MODE, END, false, Body<MR>>(
        sprof + g * W * MRS, lw, scr, B, len, steps, G, g, mine, src, put,
        last, r0, jl, MR - 1, go, ge, fl);

    // merge this pass's strips in strip order
    int seg2 = 0;
    for (int g2 = 0; g2 < G && p * G + g2 < ns; ++g2) {
      const int s2 = p * G + g2;
      while (seg2 + 1 < n_seg && a.seg_first[seg2 + 1] <= s2) ++seg2;
      merge_strip<MODE, END>(o, g2, G, best, best_r, best_c, ocm, orow);
      if (s2 != a.seg_first[seg2 + 1] - 1) continue;
      // the segment's last strip: its last-row trackers, final values
      const int Qs = a.seg_q[seg2];
      last_row<MODE>(o, g2, G, lr, lr_c, plrm, nw);
      if (lane < B && g == 0) {
        int score, eq = 0, et = 0;
        if (MODE == MODE_NW) {
          score = nw;
          eq = Qs - 1;
          et = len - 1;
        } else if (MODE == MODE_SW) {
          score = best;
          eq = best_r;
          et = best_c;
        } else if (MODE == MODE_HW) {
          score = lr;
          eq = Qs - 1;
          et = lr_c;
        } else {  // OV: the end is in the last column iff its max beats
                  // the last-row max of the earlier columns
          score = max(ocm, lr);
          const bool in_last = ocm > plrm;
          eq = in_last ? orow : Qs - 1;
          et = in_last ? len - 1 : lr_c;
        }
        // rows seg, n_seg + seg, 2 n_seg + seg
        out[(size_t)seg2 * B] = score;
        if (END) {
          out[(size_t)(n_seg + seg2) * B] = eq;
          out[(size_t)(2 * n_seg + seg2) * B] = et;
        }
      }
      best = best_r = best_c = 0;  // fresh trackers for the next segment
      lr = plrm = ocm = nw = NEG;
      lr_c = orow = 0;
    }
  }
}

template <int MODE, bool END>
int launch(const Args& a, int n_jobs, size_t smem, cudaStream_t stream) {
  return launch_kernel(multi_dp_kernel<MODE, END>, a, n_jobs, smem, stream);
}

template <int MODE, bool END>
int attrs(size_t smem, int* out) {
  return kernel_attrs(multi_dp_kernel<MODE, END>, smem, out);
}

}  // namespace

// Launches the kernel over the plan's n_jobs CUDA blocks (jobs, groups,
// scr_off and max_g as for ragged_dp_launch). seg_q holds n_seg (1..8)
// query lengths; the profile stacks the segments, each padded to
// ceil(Q / 32) * 32 rows. Returns a cudaError_t (0 on success).
extern "C" int multi_dp_launch(const void* profile, const void* letters,
                               const void* offsets, const void* lengths,
                               const void* jobs, const void* groups,
                               const void* scr_off, void* scratch, void* out,
                               int n_jobs, int max_g, int B, int W, int n_seg,
                               const int* seg_q, int mode, int track_end,
                               int go, int ge, void* stream) {
  if (W > MAX_W || W < 1 || B < 1 || n_jobs < 1 || n_seg < 1 ||
      n_seg > MAX_SEGS || max_g < 1 || max_g > MAX_G ||
      (max_g & (max_g - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(profile),
         static_cast<const int8_t*>(letters),
         static_cast<const long long*>(offsets),
         static_cast<const int*>(lengths),
         static_cast<const Job*>(jobs),
         static_cast<const int*>(groups),
         static_cast<const long long*>(scr_off),
         static_cast<int2*>(scratch),
         static_cast<int*>(out),
         B, W, go, ge, n_seg, {}, {}};
  for (int s = 0; s < n_seg; ++s) {
    if (seg_q[s] < 1) return (int)cudaErrorInvalidValue;
    a.seg_q[s] = seg_q[s];
    a.seg_first[s + 1] = a.seg_first[s] + (seg_q[s] + MR - 1) / MR;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = smem_bytes<MR>(max_g, W);
  int err;
  const bool e = track_end != 0;
  switch (mode) {
    case MODE_NW: err = e ? launch<MODE_NW, true>(a, n_jobs, smem, st)
                          : launch<MODE_NW, false>(a, n_jobs, smem, st); break;
    case MODE_HW: err = e ? launch<MODE_HW, true>(a, n_jobs, smem, st)
                          : launch<MODE_HW, false>(a, n_jobs, smem, st); break;
    case MODE_OV: err = e ? launch<MODE_OV, true>(a, n_jobs, smem, st)
                          : launch<MODE_OV, false>(a, n_jobs, smem, st); break;
    case MODE_SW: err = e ? launch<MODE_SW, true>(a, n_jobs, smem, st)
                          : launch<MODE_SW, false>(a, n_jobs, smem, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

// out[3]: resident CUDA blocks per SM of the kernel of this mode and depth
// at a largest group of max_g and profile width W, its registers and local
// (spill) bytes per thread (sg::kernel_attrs). Returns a cudaError_t (0 on
// success).
extern "C" int multi_dp_attrs(int mode, int track_end, int max_g, int W,
                              int* out) {
  if (W > MAX_W || W < 1 || max_g < 1 || max_g > MAX_G)
    return (int)cudaErrorInvalidValue;
  const size_t sm = smem_bytes<MR>(max_g, W);
  const bool e = track_end != 0;
  switch (mode) {
    case MODE_NW: return e ? attrs<MODE_NW, true>(sm, out)
                           : attrs<MODE_NW, false>(sm, out);
    case MODE_HW: return e ? attrs<MODE_HW, true>(sm, out)
                           : attrs<MODE_HW, false>(sm, out);
    case MODE_OV: return e ? attrs<MODE_OV, true>(sm, out)
                           : attrs<MODE_OV, false>(sm, out);
    case MODE_SW: return e ? attrs<MODE_SW, true>(sm, out)
                           : attrs<MODE_SW, false>(sm, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
