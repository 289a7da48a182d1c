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
// Design. One thread per database lane; a CUDA block holds THREADS lanes of
// one database block (grid.y = database block). Each thread walks its own
// columns t < len only. The query is cut into strips of R rows: a strip's
// H and E columns live in registers while the thread sweeps all its columns;
// the strip's last row (H and F per column) passes to the next strip
// through a lane-contiguous int2 scratch [t, lane] in device memory. The
// strip's profile rows (R x W int32) are staged in shared memory with an
// odd row stride, so lanes holding different letters hit different banks.
// Letters are read four columns per 32-bit load.
//
// What bounds it on the H100: integer issue. The least an SW score-only
// cell needs is 5.5 int32 instructions with Hopper's DPX forms: 2 adds
// (h - go, shared by the next column's E and the next row's F; diag +
// profile), 3 DPX (E = __viaddmax_s32(E, -ge, h - go), F likewise, H =
// __vimax3_s32_relu(E, F, diag + profile)) and half a __vimax3_s32 for the
// score tracker (two cells per instruction). The adds can issue on the FMA
// pipe; the 3.5 max-type ones only on the ALU pipe, 64 lanes per SM, which
// makes 3.5 / 64 SM-clocks per cell (all 5.5 at the schedulers' 128 per SM
// per clock take less). This kernel, without DPX, does 11 per cell (E: 2
// adds + max, F: 2 adds + max, diagonal add, H: 2 max, SW clamp, score
// tracker), 7 of them max-type. Bytes are negligible: letters are ~0.2 GB
// per whole-database search (read once per strip), scratch traffic 16 / R
// bytes per cell.
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
// is structural. The least extra work is 0.5 max-type instruction per SW
// cell (one __vimax3_s32 folds two cells) and 1.5 per NW/HW/OV cell (min E,
// min F, max H, two cells per 3-input instruction); with FLAGS false the
// kernel is the code it was without them.
//
// Left for later: DPX instructions (__viaddmax_s32, __vimax3_s32) to fuse
// add+max and max3; the profile held in registers instead of shared memory;
// query tiling across the warps of a block (inter-thread wavefront) instead
// of one lane per thread; packed 16-bit lanes where scores fit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;          // query rows per strip (== STRIP_ROWS)
constexpr int RS = R + 1;      // shared-memory stride per letter (odd)
constexpr int THREADS = 128;   // lanes per CUDA block
constexpr int MAX_W = 128;     // profile width bound (int8 letters)
constexpr int NEG = -(1 << 30);
constexpr int PAD_NEG = -(1 << 20);

enum { MODE_NW = 0, MODE_HW = 1, MODE_OV = 2, MODE_SW = 3 };

struct Args {
  const int* profile;         // [Q, W] int32
  const int8_t* letters;      // blocks back to back, [t4, B, 4] each
  const long long* offsets;   // [NB + 1] byte offset of each block
  const int* lengths;         // [NB, B]
  int2* scratch;              // (H, F) of a strip's last row, per cell
  int* out;                   // [NB, rows, B]
  int first_block, B, Q, W, go, ge;
};

template <int MODE, bool END, bool FLAGS>
__global__ void __launch_bounds__(THREADS) ragged_dp_kernel(Args a) {
  __shared__ int sprof[MAX_W * RS];
  constexpr bool WALL = MODE == MODE_NW || MODE == MODE_HW;
  const int blk = a.first_block + blockIdx.y;
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  const int B = a.B, Q = a.Q, W = a.W, go = a.go, ge = a.ge;
  const int len = lane < B ? a.lengths[(long long)blk * B + lane] : 0;
  const long long boff = a.offsets[blk];
  const uint32_t* lw =
      reinterpret_cast<const uint32_t*>(a.letters + boff) + lane;
  int2* scr = a.scratch == nullptr
                  ? nullptr
                  : a.scratch + (boff - a.offsets[a.first_block]) + lane;
  const int ns = (Q + R - 1) / R;

  // lane trackers
  int best = 0, best_r = 0, best_c = 0;  // SW
  int lr = NEG, lr_c = 0, plrm = NEG;    // HW / OV last row
  int ocm = NEG, orow = 0;               // OV last column
  int nw = NEG;                          // NW
  // overflow flags: SW max ulH+P | min E, min F, max H
  int fl_ulhp = NEG, fl_mine = 0, fl_minf = 0, fl_maxh = NEG;

  for (int s = 0; s < ns; ++s) {
    const int r0 = s * R;
    const bool last = s == ns - 1;
    const int jl = Q - 1 - r0;  // row Q-1 within the last strip
    const int jv = last ? jl : R - 1;  // last real row of this strip
    __syncthreads();
    for (int i = threadIdx.x; i < W * R; i += THREADS) {
      const int c = i / R, j = i - c * R;
      // rows past Q are padding: PAD_NEG keeps their diagonal candidate
      // out, so their H only ever repeats (never beats) real values
      sprof[c * RS + j] = r0 + j < Q ? a.profile[(r0 + j) * W + c] : PAD_NEG;
    }
    __syncthreads();
    if (len == 0) continue;

    int H[R], E[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      H[j] = WALL ? -go - (r0 + j) * ge : 0;  // H[r][-1]
      E[j] = MODE == MODE_SW ? 0 : NEG;       // E[r][-1]
    }
    // diagonal input of row r0 at column 0: H[r0-1][-1]
    int ul = (s > 0 && WALL) ? -go - (r0 - 1) * ge : 0;
    int sb = 0, st = 0, sr = 0;  // SW end tracker of this strip

    for (int t4 = 0; t4 < len; t4 += 4) {
      const uint32_t w = __ldg(lw + (size_t)(t4 >> 2) * B);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t4 + k;
        if (t >= len) break;
        const int* pr = sprof + ((w >> (8 * k)) & 0x7f) * RS;
        int hu, fu;  // H[r0-1][t], F[r0-1][t]
        if (s == 0) {
          hu = MODE == MODE_NW ? -go - t * ge : 0;
          fu = MODE == MODE_SW ? 0 : NEG;
        } else {
          const int2 b = scr[(size_t)t * B];
          hu = b.x;
          fu = b.y;
        }
        int diag = ul;
        ul = hu;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int e = max(H[j] - go, E[j] - ge);
          const int f = max(hu - go, fu - ge);
          const int d = diag + pr[j];  // ulH + P
          int h = max(max(e, f), d);
          if (MODE == MODE_SW) h = max(h, 0);
          if (FLAGS && j <= jv) {  // real rows only (see the header)
            if (MODE == MODE_SW) {
              fl_ulhp = max(fl_ulhp, d);
            } else {
              fl_mine = min(fl_mine, e);
              fl_minf = min(fl_minf, f);
              fl_maxh = max(fl_maxh, h);
            }
          }
          diag = H[j];
          H[j] = h;
          E[j] = e;
          hu = h;
          fu = f;
          // Padding rows need no mask here: they repeat real values at
          // most, and only at later rows or columns, so neither the
          // running max nor a strict first improvement can pick them.
          if (MODE == MODE_SW) {
            if (END) {
              if (h > sb) {
                sb = h;
                st = t;
                sr = r0 + j;
              }
            } else {
              best = max(best, h);
            }
          }
        }
        if (!last) {
          scr[(size_t)t * B] = make_int2(hu, fu);
        } else if (MODE == MODE_HW || MODE == MODE_OV) {
          int v = H[0];
#pragma unroll
          for (int j = 1; j < R; ++j)
            if (j == jl) v = H[j];
          plrm = lr;  // last-row max before this column
          if (v > lr) {
            lr = v;
            lr_c = t;
          }
        }
      }
    }

    // H now holds column len-1
    if (MODE == MODE_SW && END) {
      // strips come in row order: on a tie, keep the earlier strip's end
      // unless this strip reached the value in an earlier column
      if (sb > best || (sb == best && sb > 0 && st < best_c)) {
        best = sb;
        best_c = st;
        best_r = sr;
      }
    }
    if (MODE == MODE_OV) {
      int cm = NEG, cr = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if ((!last || j <= jl) && H[j] > cm) {
          cm = H[j];
          cr = r0 + j;
        }
      }
      if (cm > ocm) {
        ocm = cm;
        orow = cr;
      }
    }
    if (MODE == MODE_NW && last) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (j == jl) nw = H[j];
    }
  }

  if (lane >= B) return;
  // tracker rows, as kernels.tracker_rows lists them
  constexpr int SROWS = (MODE == MODE_NW || !END) ? 1 : MODE == MODE_HW ? 2 : 3;
  constexpr int ROWS = SROWS + (FLAGS ? (MODE == MODE_SW ? 1 : 3) : 0);
  int* o = a.out + (size_t)blk * ROWS * B + lane;
  if (FLAGS) {  // after the score rows, in opal_tpu's order
    if (MODE == MODE_SW) {
      o[SROWS * B] = fl_ulhp;
    } else {
      o[SROWS * B] = fl_mine;
      o[(SROWS + 1) * B] = fl_minf;
      o[(SROWS + 2) * B] = fl_maxh;
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

template <int MODE, bool END, bool FLAGS>
void launch(const Args& a, int n_blocks, cudaStream_t stream) {
  const dim3 grid((a.B + THREADS - 1) / THREADS, n_blocks);
  ragged_dp_kernel<MODE, END, FLAGS><<<grid, THREADS, 0, stream>>>(a);
}

// the four (END, FLAGS) instantiations of one mode
template <int MODE>
void launch_mode(const Args& a, int n_blocks, cudaStream_t st, bool e,
                 bool f) {
  if (f) {
    e ? launch<MODE, true, true>(a, n_blocks, st)
      : launch<MODE, false, true>(a, n_blocks, st);
  } else {
    e ? launch<MODE, true, false>(a, n_blocks, st)
      : launch<MODE, false, false>(a, n_blocks, st);
  }
}

}  // namespace

// Launches the kernel over blocks [first_block, first_block + n_blocks).
// scratch holds 2 int32 per byte of those blocks' letters (may be null when
// Q <= R). with_flags adds the overflow-flag rows after the score rows.
// Returns cudaGetLastError() (0 on success).
extern "C" int ragged_dp_launch(const void* profile, const void* letters,
                                const void* offsets, const void* lengths,
                                void* scratch, void* out, int first_block,
                                int n_blocks, int B, int Q, int W, int mode,
                                int track_end, int with_flags, int go, int ge,
                                void* stream) {
  if (W > MAX_W || W < 1 || Q < 1 || B < 1 || n_blocks < 1 ||
      n_blocks > 65535 || (Q > R && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(profile),
         static_cast<const int8_t*>(letters),
         static_cast<const long long*>(offsets),
         static_cast<const int*>(lengths),
         static_cast<int2*>(scratch),
         static_cast<int*>(out),
         first_block, B, Q, W, go, ge};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool e = track_end != 0, f = with_flags != 0;
  switch (mode) {
    case MODE_NW: launch_mode<MODE_NW>(a, n_blocks, st, e, f); break;
    case MODE_HW: launch_mode<MODE_HW>(a, n_blocks, st, e, f); break;
    case MODE_OV: launch_mode<MODE_OV>(a, n_blocks, st, e, f); break;
    case MODE_SW: launch_mode<MODE_SW>(a, n_blocks, st, e, f); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
