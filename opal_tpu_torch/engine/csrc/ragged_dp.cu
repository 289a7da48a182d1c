// ragged_dp: one query against a whole resident database, affine-gap DP.
//
// Replaces opal_tpu's Pallas TPU kernel build_pallas_ragged_fn_raw /
// _kernel_body (opal_tpu/engine/pallas_kernels.py:825-924, body :264-728):
// all four modes (NW, HW, OV, SW) at score and score+end depth. It computes
// what that kernel computes, with the semantics of opal_tpu's int32 twin
// (opal_tpu/engine/xla.py:98-256), and none of its TPU mechanics: exact
// int32 arithmetic, a sequential F chain (exact for any gap pair, so
// gap_ext > gap_open and gap_open == gap_ext == 0 run here too), no query
// length ceiling.
//
// What bounds it on the H100: integer issue along a serial chain. The least
// an SW score-only cell needs is 3.5 max-type instructions (Hopper's DPX
// forms), which only the ALU pipe issues, 64 per SM per clock; nvcc
// already compiles the plain max/+ source below into them (3.73 per cell,
// measured from the SASS by opal_tpu_torch/tools/exp_unroll). Bytes are
// negligible: letters are ~0.2 GB per whole-database search. On a full
// grid the body runs at ~41 % of that ceiling, held by the latency of each
// column's 16-row chain; what it loses beyond that is the fill: a lane is
// a serial chain of ceil(Q / R) strips x len columns, the longest lanes
// decide when a launch ends, and a launch of few CUDA blocks leaves SMs
// idle.
//
// Design: strip groups (strip_group.cuh). The query is cut into strips of
// R = 16 rows; a strip's H and E columns live in registers. The strips of
// one lane go to a group of G threads of one warp (G = 1, 2, 4 or 8):
// thread g owns strips g, g + G, ..., and a pass of the group sweeps G
// strips as a wavefront along the columns. At step k thread g computes
// column k - g of its strip and takes the row above (H, F at that column)
// from thread g - 1 with __shfl_up_sync; thread 0 takes the mode's wall at
// row 0, else the last row the previous pass (or panel) left in a
// lane-contiguous int2 scratch [t, lane]. A lane's chain drops from
// ceil(Q / R) x len columns to ceil(Q / (R G)) x (len + G - 1) steps; G - 1
// steps of lag per pass are the price. Every warp steps to its longest
// lane (lanes of a block are length-sorted, so neighbours are alike);
// shorter, empty and absent lanes mask their cells but still shuffle.
// - G per database block is the host plan's (kernels.plan_launch), from
//   the block's longest lane: the smallest G that puts a query of up to
//   8 strips in one pass (Q <= 128: no scratch, no hand-off through device
//   memory at all), and for taller queries the smallest G whose longest
//   chain fits the launch's per-thread share of the work.
// - Launch: every database block in one grid, as CUDA blocks of THREADS
//   threads (THREADS / G lanes each), listed longest block first by the
//   plan (Job): the longest chains start at once and short blocks fill the
//   SMs behind them. Scratch exists only for blocks that hand rows between
//   passes or panels; the plan splits the database into several launches
//   only where that scratch would not fit its budget.
// - The profile: a pass's G strips (G x R rows x W letters, 17.4 KB at
//   G = 8, W = 32) in dynamic shared memory with an odd row stride, staged
//   once per pass by the whole CUDA block.
// - Letters: each thread loads its lane's 32-bit word (four columns) when
//   its column reaches a multiple of four; the G threads of a lane read the
//   same word a step apart, from L1.
// - The group's trackers merge after each pass in strip order, through
//   shuffles, with the one-thread rules: SW keeps the earlier strip's end
//   unless a later strip reached the value in an earlier column (smallest
//   end_t, then smallest end_q); OV's last-column max keeps the earlier
//   strip on ties; the last-row trackers (HW, OV, NW) come from the thread
//   that owns row Q-1. Thread 0 of the group writes the lane's rows.
//
// Overflow flags (FLAGS, K4). Also replaces the with_flags branch of
// _kernel_body (pallas_kernels.py:525-549, rows :199-202), with the int32
// semantics of xla.py:136-141, 201-216, 250-255: per lane, over its valid
// cells, SW keeps the running max of the diagonal candidate ulH + P (before
// the max with E and F and the clamp at 0); NW, HW and OV keep min E and
// min F (both start at 0, as a masked cell counts 0) and max H. The rows
// follow the score rows (TR_ULHP, or TR_MIN_E, TR_MIN_F, TR_MAX_H) and are
// what engine/cascade.py reads. Unlike the score trackers, the flags must
// mask the padding rows of the last strip: below row Q-1 F can fall by ge
// per row and E follows the padded H, to values no real cell holds.
// Columns at or past a lane's length are never walked, so the column mask
// is structural. Each thread keeps the flags of its strips; the group
// reduces them at the end (min and max: order-free).
//
// Query panels (PANEL, K6). Also replaces opal_tpu's query-panel kernel
// build_pallas_panel_fn_raw (pallas_kernels.py:959-1082, boundary rows
// :412-458, emits :674-694): a launch covers the query rows [row0, row0 +
// rows) of a query of Q rows. The panel that starts at row 0 takes the
// mode's row -1 wall; a later panel's first strip reads its top boundary
// from the scratch the previous panel's last strip left there, which is
// what the TPU kernel's bh/bx rows carry (bh[t] = H[t-1], bx[t] = max(H[t] -
// go, F[t] - ge) of the row above). The panel that holds row Q-1 (final)
// alone keeps the last-row trackers. Each panel emits its own rows, as
// kernels.panel_tracker_rows lists them, with end rows local to the panel;
// kernels.finalize_panels_device merges them on the card. The panels of a
// launch plan run in order on one stream over the same blocks and share
// their scratch. With PANEL false the kernel is the code it was without it
// (row0 = 0, one panel).

#include "strip_group.cuh"

namespace {

using namespace sg;

struct Args {
  const int* profile;         // [Q, W] int32
  const int8_t* letters;      // blocks back to back, [t4, B, 4] each
  const long long* offsets;   // [NB + 1] byte offset of each block
  const int* lengths;         // [NB, B]
  const Job* jobs;            // [grid] the plan's CUDA blocks
  const int* groups;          // [NB] G of each block
  const long long* scr_off;   // [NB] the block's first scratch cell, or -1
  int2* scratch;              // (H, F) of a pass's last row, per cell
  int* out;                   // [NB, rows, B]
  int B, Q, W, go, ge;
  int row0, rows;             // PANEL: the query rows of this launch
};

template <int MODE, bool END, bool FLAGS, bool PANEL>
__global__ void __launch_bounds__(THREADS) ragged_dp_kernel(Args a) {
  extern __shared__ int sprof[];  // [G][W][RS]
  const Job job = a.jobs[blockIdx.x];
  const int blk = job.blk;
  const int G = a.groups[blk];
  const int g = threadIdx.x & (G - 1);
  const int lane = job.lane0 + threadIdx.x / G;
  const int B = a.B, Q = a.Q, W = a.W, go = a.go, ge = a.ge;
  const int len = lane < B ? a.lengths[(size_t)blk * B + lane] : 0;
  const int wlen = __reduce_max_sync(FULL, len);
  const int steps = wlen > 0 ? wlen + G - 1 : 0;
  const uint32_t* lw =
      reinterpret_cast<const uint32_t*>(a.letters + a.offsets[blk]) + lane;
  const long long so = a.scr_off[blk];
  int2* scr = so < 0 ? nullptr : a.scratch + so + lane;
  // without PANEL one launch covers every row: row0 = 0, final
  const int row0 = PANEL ? a.row0 : 0;
  const bool is_final = PANEL ? row0 + a.rows == Q : true;
  const int ns = ((PANEL ? a.rows : Q) + R - 1) / R;
  const int passes = (ns + G - 1) / G;

  // the group's trackers (rows are global; a panel emits them local),
  // the same in every thread of the group after each merge
  int best = 0, best_r = row0, best_c = 0;  // SW
  int lr = NEG, lr_c = 0, plrm = NEG;       // HW / OV last row
  int ocm = NEG, orow = row0;               // OV last column
  int nw = NEG;                             // NW
  // overflow flags of this thread's strips
  Flags fl{NEG, 0, 0, NEG};

  for (int p = 0; p < passes; ++p) {
    stage_profile(sprof, a.profile, row0 + p * G * R, Q, G, W);
    const int s = p * G + g;  // this thread's strip
    const bool mine = s < ns;
    const int r0 = row0 + s * R;  // global row of the strip's row 0
    const bool last = is_final && s == ns - 1;  // the strip holding row Q-1
    const int jl = Q - 1 - r0;  // row Q-1 within the last strip
    // the last row goes on to the next pass, or to the next panel
    const bool put = mine && ((g == G - 1 && s + 1 < ns) ||
                              (PANEL && !is_final && s == ns - 1));
    const int src = g > 0 ? SRC_SHUFFLE : r0 > 0 ? SRC_SCRATCH : SRC_WALL;
    const StripOut o = sweep<MODE, END, FLAGS>(
        sprof + g * W * RS, lw, scr, B, len, steps, G, g, mine, src, put,
        last, r0, jl, last ? jl : R - 1, go, ge, fl);

    // merge this pass's strips in strip order
    for (int g2 = 0; g2 < G && p * G + g2 < ns; ++g2) {
      merge_strip<MODE, END>(o, g2, G, best, best_r, best_c, ocm, orow);
      if (is_final && p * G + g2 == ns - 1)  // the strip of row Q-1
        last_row<MODE>(o, g2, G, lr, lr_c, plrm, nw);
    }
  }
  if (FLAGS) {  // reduce the group's flags
    for (int off = G / 2; off > 0; off >>= 1) {
      if (MODE == MODE_SW) {
        fl.ulhp = max(fl.ulhp, __shfl_xor_sync(FULL, fl.ulhp, off, G));
      } else {
        fl.mine = min(fl.mine, __shfl_xor_sync(FULL, fl.mine, off, G));
        fl.minf = min(fl.minf, __shfl_xor_sync(FULL, fl.minf, off, G));
        fl.maxh = max(fl.maxh, __shfl_xor_sync(FULL, fl.maxh, off, G));
      }
    }
  }

  if (lane >= B || g != 0) return;
  if (PANEL) {  // rows as kernels.panel_tracker_rows lists them
    const int nrows =
        (MODE == MODE_SW   ? 1 + 2 * END
         : MODE == MODE_NW ? (is_final ? 1 : 0)
         : MODE == MODE_HW ? (is_final ? 1 + END : 0)
                           : (is_final ? 1 + 2 * END : 0) + 1 + END) +
        (FLAGS ? (MODE == MODE_SW ? 1 : 3) : 0);
    int* o = a.out + (size_t)blk * max(nrows, 1) * B + lane;
    auto put = [&](int v) {
      *o = v;
      o += B;
    };
    if (nrows == 0) put(NEG);  // a filler row: the merge reads nothing here
    if (MODE == MODE_SW) {
      put(best);
      if (END) {
        put(best_r - row0);
        put(best_c);
      }
    } else if (MODE == MODE_NW) {
      if (is_final) put(nw);
    } else if (MODE == MODE_HW) {
      if (is_final) {
        put(lr);
        if (END) put(lr_c);
      }
    } else {  // OV: the last-row rows, then this panel's last column
      if (is_final) {
        put(lr);
        if (END) {
          put(lr_c);
          put(plrm);
        }
      }
      put(ocm);
      if (END) put(orow - row0);
    }
    if (FLAGS) {
      if (MODE == MODE_SW) {
        put(fl.ulhp);
      } else {
        put(fl.mine);
        put(fl.minf);
        put(fl.maxh);
      }
    }
    return;
  }
  // tracker rows, as kernels.tracker_rows lists them
  constexpr int SROWS = (MODE == MODE_NW || !END) ? 1 : MODE == MODE_HW ? 2 : 3;
  constexpr int ROWS = SROWS + (FLAGS ? (MODE == MODE_SW ? 1 : 3) : 0);
  int* o = a.out + (size_t)blk * ROWS * B + lane;
  if (FLAGS) {  // after the score rows, in opal_tpu's order
    if (MODE == MODE_SW) {
      o[SROWS * B] = fl.ulhp;
    } else {
      o[SROWS * B] = fl.mine;
      o[(SROWS + 1) * B] = fl.minf;
      o[(SROWS + 2) * B] = fl.maxh;
    }
  }
  if (MODE == MODE_NW) {
    o[0] = nw;
  } else if (MODE == MODE_SW) {
    o[0] = best;
    if (END) {
      o[B] = best_r;
      o[2 * B] = best_c;
    }
  } else if (MODE == MODE_HW) {
    o[0] = lr;
    if (END) o[B] = lr_c;
  } else {  // OV: the end is in the last column iff its max beats the
            // last-row max of the earlier columns
    o[0] = max(ocm, lr);
    if (END) {
      const bool in_last = ocm > plrm;
      o[B] = in_last ? orow : Q - 1;
      o[2 * B] = in_last ? len - 1 : lr_c;
    }
  }
}

template <int MODE, bool END, bool FLAGS, bool PANEL>
int launch(const Args& a, int n_jobs, size_t smem, cudaStream_t stream) {
  return launch_kernel(ragged_dp_kernel<MODE, END, FLAGS, PANEL>, a, n_jobs,
                       smem, stream);
}

// the four (END, FLAGS) instantiations of one mode
template <int MODE, bool PANEL>
int launch_mode(const Args& a, int n, size_t smem, cudaStream_t st, bool e,
                bool f) {
  if (f) {
    return e ? launch<MODE, true, true, PANEL>(a, n, smem, st)
             : launch<MODE, false, true, PANEL>(a, n, smem, st);
  }
  return e ? launch<MODE, true, false, PANEL>(a, n, smem, st)
           : launch<MODE, false, false, PANEL>(a, n, smem, st);
}

template <bool PANEL>
int launch_any(const Args& a, int n, size_t smem, void* stream, int mode,
               int track_end, int with_flags) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool e = track_end != 0, f = with_flags != 0;
  int err;
  switch (mode) {
    case MODE_NW: err = launch_mode<MODE_NW, PANEL>(a, n, smem, st, e, f); break;
    case MODE_HW: err = launch_mode<MODE_HW, PANEL>(a, n, smem, st, e, f); break;
    case MODE_OV: err = launch_mode<MODE_OV, PANEL>(a, n, smem, st, e, f); break;
    case MODE_SW: err = launch_mode<MODE_SW, PANEL>(a, n, smem, st, e, f); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

// Launches the kernel over the plan's n_jobs CUDA blocks (jobs: int32
// pairs (database block, first lane), longest block first; groups: G per
// database block, 1, 2, 4 or 8; scr_off: each block's first int2 cell in
// scratch, -1 for a block whose lanes hand nothing through memory). max_g
// is the largest G among the jobs' blocks (it sizes shared memory). The
// rows [row0, row0 + rows) of the Q-row profile are swept; with panel 0
// they must be all of them. In the panel role (panel 1) row0 is a multiple
// of R, a panel that does not end at row Q-1 has a multiple of R rows and
// leaves its last row in scratch for the next panel, which must run next
// on the same stream over the same plan; out holds the panel's rows
// (kernels.panel_tracker_rows), else kernels.tracker_rows. with_flags adds
// the overflow-flag rows. Returns a cudaError_t (0 on success).
extern "C" int ragged_dp_launch(
    const void* profile, const void* letters, const void* offsets,
    const void* lengths, const void* jobs, const void* groups,
    const void* scr_off, void* scratch, void* out, int n_jobs, int max_g,
    int B, int Q, int row0, int rows, int W, int mode, int track_end,
    int with_flags, int panel, int go, int ge, void* stream) {
  if (W > MAX_W || W < 1 || Q < 1 || B < 1 || n_jobs < 1 || max_g < 1 ||
      max_g > MAX_G || (max_g & (max_g - 1)) != 0 || row0 < 0 || rows < 1 ||
      row0 % R != 0 || row0 + rows > Q ||
      (row0 + rows < Q && rows % R != 0) || (!panel && (row0 || rows != Q)))
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
         B, Q, W, go, ge, row0, rows};
  const size_t smem = smem_bytes(max_g, W);
  return panel ? launch_any<true>(a, n_jobs, smem, stream, mode, track_end,
                                  with_flags)
               : launch_any<false>(a, n_jobs, smem, stream, mode, track_end,
                                   with_flags);
}

// out[3]: resident CUDA blocks per SM of the SW score-only kernel (no
// flags, no panel) at a largest group of max_g and profile width W, its
// registers and local (spill) bytes per thread (sg::kernel_attrs). Returns
// a cudaError_t (0 on success).
extern "C" int ragged_dp_sw_attrs(int max_g, int W, int* out) {
  if (W > MAX_W || W < 1 || max_g < 1 || max_g > MAX_G)
    return (int)cudaErrorInvalidValue;
  return kernel_attrs(ragged_dp_kernel<MODE_SW, false, false, false>,
                      smem_bytes(max_g, W), out);
}
