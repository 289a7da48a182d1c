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
// Design. ragged_dp's: one thread per database lane, a CUDA block holds
// THREADS lanes of one database block (grid.y = database block), each
// thread walks its own columns t < len only, 16-row register strips of H
// and E, the strip's profile rows in shared memory (odd stride), four
// letters per 32-bit load, and a strip's last row (H, F per column) passed
// to the next strip through a lane-contiguous int2 scratch. The strips
// walked are those of the STACKED profile, so the whole group is one launch
// per wave of blocks. Every segment is padded (PAD_NEG rows) to a multiple
// of R rows on the host, so no strip spans two segments, and isolation is
// structural: each segment starts with fresh lane trackers, its first
// strip takes its top boundary from the wall (never from scratch), and
// after its last strip the thread writes that segment's final values.
//
// The strip sweep below is ragged_dp's, line for line. It is a copy, not a
// shared header: sharing it changed ragged_dp's register allocation.
//
// What bounds it on the H100: integer issue, as for ragged_dp (letters are
// read once per strip; scratch traffic is 16 / R bytes per cell). The
// least an SW score-only cell needs is 3.5 ALU-pipe instructions with
// Hopper's DPX forms (see ragged_dp.cu); this kernel does ragged_dp's 11
// without DPX. Against N ragged_dp launches it saves N-1 launches and their
// tails, not DP work.
//
// Left for later: DPX, the profile in registers, query tiling across warps
// (as for ragged_dp); reading each letter word once for several segments.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 16;          // query rows per strip (== STRIP_ROWS)
constexpr int RS = R + 1;      // shared-memory stride per letter (odd)
constexpr int THREADS = 128;   // lanes per CUDA block
constexpr int MAX_W = 128;     // profile width bound (int8 letters)
constexpr int MAX_SEGS = 8;    // == MULTI_MAX_SEGS
constexpr int NEG = -(1 << 30);

enum { MODE_NW = 0, MODE_HW = 1, MODE_OV = 2, MODE_SW = 3 };

struct Args {
  const int* profile;         // [n_strips * R, W] int32, segments stacked
  const int8_t* letters;      // blocks back to back, [t4, B, 4] each
  const long long* offsets;   // [NB + 1] byte offset of each block
  const int* lengths;         // [NB, B]
  int2* scratch;              // (H, F) of a strip's last row, per cell
  int* out;                   // [NB, n_seg * (END ? 3 : 1), B]
  int first_block, B, W, go, ge, n_seg;
  int seg_q[MAX_SEGS];        // real rows of each segment
  int seg_strips[MAX_SEGS];   // strips of each segment (ceil(Q / R))
};

template <int MODE, bool END>
__global__ void __launch_bounds__(THREADS) multi_dp_kernel(Args a) {
  __shared__ int sprof[MAX_W * RS];
  constexpr bool WALL = MODE == MODE_NW || MODE == MODE_HW;
  const int blk = a.first_block + blockIdx.y;
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  const int B = a.B, W = a.W, go = a.go, ge = a.ge, n_seg = a.n_seg;
  const int len = lane < B ? a.lengths[(long long)blk * B + lane] : 0;
  const long long boff = a.offsets[blk];
  const uint32_t* lw =
      reinterpret_cast<const uint32_t*>(a.letters + boff) + lane;
  int2* scr = a.scratch == nullptr
                  ? nullptr
                  : a.scratch + (boff - a.offsets[a.first_block]) + lane;
  constexpr int ROWS = END ? 3 : 1;  // output rows per segment
  int* o = a.out + (size_t)blk * ROWS * n_seg * B + lane;

  // lane trackers of the current segment
  int best = 0, best_r = 0, best_c = 0;  // SW
  int lr = NEG, lr_c = 0, plrm = NEG;    // HW / OV last row
  int ocm = NEG, orow = 0;               // OV last column
  int nw = NEG;                          // NW

  int g = 0;  // strip of the stacked profile
  for (int seg = 0; seg < n_seg; ++seg) {
    const int Q = a.seg_q[seg];
    const int ns = a.seg_strips[seg];
    for (int s = 0; s < ns; ++s, ++g) {
      const int r0 = s * R;  // first row of the strip within its segment
      const bool last = s == ns - 1;
      const int jl = Q - 1 - r0;  // row Q-1 within the last strip
      __syncthreads();
      for (int i = threadIdx.x; i < W * R; i += THREADS) {
        const int c = i / R, j = i - c * R;
        // rows past Q hold PAD_NEG (host padding): their diagonal
        // candidate stays out, so their H only ever repeats real values
        sprof[c * RS + j] = a.profile[(g * R + j) * W + c];
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
          if (s == 0) {  // the segment's top wall, never a neighbour's row
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
            int h = max(max(e, f), diag + pr[j]);
            if (MODE == MODE_SW) h = max(h, 0);
            diag = H[j];
            H[j] = h;
            E[j] = e;
            hu = h;
            fu = f;
            // padding rows need no mask (see ragged_dp.cu)
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
        // strips come in row order: on a tie, keep the earlier strip's
        // end unless this strip reached the value in an earlier column
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

    // the segment's final values: rows seg, n_seg + seg, 2 n_seg + seg
    if (lane < B) {
      int score, eq = 0, et = 0;
      if (MODE == MODE_NW) {
        score = nw;
        eq = Q - 1;
        et = len - 1;
      } else if (MODE == MODE_SW) {
        score = best;
        eq = best_r;
        et = best_c;
      } else if (MODE == MODE_HW) {
        score = lr;
        eq = Q - 1;
        et = lr_c;
      } else {  // OV: the end is in the last column iff its max beats the
                // last-row max of the earlier columns
        score = max(ocm, lr);
        const bool in_last = ocm > plrm;
        eq = in_last ? orow : Q - 1;
        et = in_last ? len - 1 : lr_c;
      }
      o[(size_t)seg * B] = score;
      if (END) {
        o[(size_t)(n_seg + seg) * B] = eq;
        o[(size_t)(2 * n_seg + seg) * B] = et;
      }
    }
    best = best_r = best_c = 0;  // fresh trackers for the next segment
    lr = plrm = ocm = nw = NEG;
    lr_c = orow = 0;
  }
}

template <int MODE, bool END>
void launch(const Args& a, int n_blocks, cudaStream_t stream) {
  const dim3 grid((a.B + THREADS - 1) / THREADS, n_blocks);
  multi_dp_kernel<MODE, END><<<grid, THREADS, 0, stream>>>(a);
}

}  // namespace

// Launches the kernel over blocks [first_block, first_block + n_blocks).
// seg_q holds n_seg (1..8) query lengths; the profile stacks the segments,
// each padded to ceil(Q / 16) * 16 rows. scratch holds 2 int32 per byte of
// those blocks' letters (may be null when no segment has more than 16
// rows). Returns cudaGetLastError() (0 on success).
extern "C" int multi_dp_launch(const void* profile, const void* letters,
                               const void* offsets, const void* lengths,
                               void* scratch, void* out, int first_block,
                               int n_blocks, int B, int W, int n_seg,
                               const int* seg_q, int mode, int track_end,
                               int go, int ge, void* stream) {
  if (W > MAX_W || W < 1 || B < 1 || n_blocks < 1 || n_blocks > 65535 ||
      n_seg < 1 || n_seg > MAX_SEGS)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(profile),
         static_cast<const int8_t*>(letters),
         static_cast<const long long*>(offsets),
         static_cast<const int*>(lengths),
         static_cast<int2*>(scratch),
         static_cast<int*>(out),
         first_block, B, W, go, ge, n_seg, {}, {}};
  bool tall = false;
  for (int s = 0; s < n_seg; ++s) {
    if (seg_q[s] < 1) return (int)cudaErrorInvalidValue;
    a.seg_q[s] = seg_q[s];
    a.seg_strips[s] = (seg_q[s] + R - 1) / R;
    tall = tall || seg_q[s] > R;
  }
  if (tall && scratch == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool e = track_end != 0;
  switch (mode) {
    case MODE_NW: e ? launch<MODE_NW, true>(a, n_blocks, st)
                    : launch<MODE_NW, false>(a, n_blocks, st); break;
    case MODE_HW: e ? launch<MODE_HW, true>(a, n_blocks, st)
                    : launch<MODE_HW, false>(a, n_blocks, st); break;
    case MODE_OV: e ? launch<MODE_OV, true>(a, n_blocks, st)
                    : launch<MODE_OV, false>(a, n_blocks, st); break;
    case MODE_SW: e ? launch<MODE_SW, true>(a, n_blocks, st)
                    : launch<MODE_SW, false>(a, n_blocks, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
