// device_fill: the alignment fill and backtrace walk of a group of x2
// winners, one pair per lane.
//
// Replaces opal_tpu's _fill_walk_fn (opal_tpu/engine/device_fill.py:90-318,
// XLA lax.scan, not Pallas): per lane, a banded NW-boundary Gotoh DP over
// the reversed prefixes aq [Qp, B] x at [Tp, B] in exact int32, recording
// five decision bits per cell (H == E, H == F, E opened, F opened, match)
// in a [Tp, Qp, B] uint8 matrix that never leaves the card, trackers that
// follow traceback.find_alignment's early stop and end rules per mode, and
// the backtrace walk over those bits. Only the op codes come back, two
// walk steps per byte in base 5 ([(Qp + Tp + 4) / 2, B]).
//
// It computes what _fill_walk_fn computes, with none of its TPU mechanics:
// - the F chain is the plain sequential recurrence F(r) = max(H(r-1) - go,
//   F(r-1) - ge), seeded at the first in-band row as at :146-157; it
//   equals opal_tpu's max-plus rewrite for ge <= go, which the host driver
//   (engine/device_fill.py) demands;
// - a lane stops at its loop guard (a column runs while the pre-column max
//   is below the limit; NW has no early stop): the walk never reads a
//   column past the last executed one;
// - bits are written for the rows below qlen of each executed column, the
//   cells the walk can reach; out-of-band cells hold opal_tpu's sentinel
//   bits (H = E = F = LSB), so the walk reads the same bits as opal_tpu's
//   wherever it steps;
// - the end row (SW, OV) is the first in-band row of the last executed
//   column equal to the final max: that column's H is still in the
//   lane-minor scratch, which is scanned once after the fill.
//
// What bounds it on the H100: one thread walks its lane's cells in series,
// so the longest lane of a group decides the launch; a group of B lanes is
// B threads (B / 128 CUDA blocks, 512 lanes at most), far from filling the
// card's 132 SMs, so no other warp hides the latency of a cell's chain (E,
// H', F, H, the bit compares, the scratch and bit stores). The design keeps
// each step cheap: per-row state [Qp, B] and the bits lane-minor, so a
// warp's loads and stores coalesce (the state of a 512-lane group, 2.4 MB
// at Qp 576, stays in L2); rows are taken CHUNK at a time with their loads
// issued before the chain runs through them (16 or 32 were slower on the
// card); the [A, A] matrix sits in shared memory. Bytes are small beside
// that: one bit byte per cell, written once. A faster mapping (a lane's
// rows spread over the threads of a warp, as strip_group.cuh does) is
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // lanes per CUDA block
constexpr int CHUNK = 8;      // rows whose loads are issued together
constexpr int MAX_A = 128;    // alphabet bound (kernels.MAX_ALPHABET)
constexpr int LSB = -(1 << 30);
constexpr int NEG2 = LSB - (1 << 24);
constexpr int BIGR = 1 << 24;
enum { MODE_NW = 0, MODE_HW = 1, MODE_OV = 2, MODE_SW = 3 };
enum { ALIGN_MATCH = 0, ALIGN_DEL = 1, ALIGN_INS = 2, ALIGN_MISMATCH = 3 };

struct Args {
  const int* aq;      // [Qp, B] letters of the reversed query prefixes
  const int* at;      // [Tp, B] letters of the reversed target prefixes
  const int* qlen;    // [B] each lane's rows, columns, band and limit
  const int* tlen;
  const int* bottom;
  const int* top;
  const int* limit;
  const int* matrix;  // [A, A]
  int* hs;            // [Qp, B] scratch: the last column's in-band H
  int* es;            // [Qp, B] scratch: its E
  uint8_t* dirs;      // [Tp, Qp, B] decision bits
  int* score;         // [B]
  int* rend_q;        // [B] end of the reversed problem
  int* rend_t;        // [B]
  uint8_t* ok;        // [B] bool
  uint8_t* codes;     // [(Qp + Tp + 4) / 2, B]
  int Qp, Tp, B, A, go, ge;
};

template <int MODE>
__global__ void __launch_bounds__(THREADS) device_fill_kernel(Args a) {
  extern __shared__ int mat[];  // [A, A]
  for (int i = threadIdx.x; i < a.A * a.A; i += THREADS) mat[i] = a.matrix[i];
  __syncthreads();
  const int lane = blockIdx.x * THREADS + threadIdx.x;
  if (lane >= a.B) return;

  const size_t B = a.B;
  const size_t col_stride = (size_t)a.Qp * B;
  const int* __restrict__ aq = a.aq + lane;  // row r at aq[r * B]
  int* __restrict__ hs = a.hs + lane;
  int* __restrict__ es = a.es + lane;
  uint8_t* __restrict__ dirs = a.dirs + lane;
  const int qlen = a.qlen[lane], tlen = a.tlen[lane];
  const int bottom = a.bottom[lane], top = a.top[lane];
  const int limit = a.limit[lane];
  const int go = a.go, ge = a.ge, A = a.A;

  // ---- fill, column by column
  int m = NEG2, h_last = LSB;
  int prs = 0, pre = -1;  // the previous column's band [prs, pre]
  int c = 0;
  for (; c < tlen; ++c) {
    if (MODE != MODE_NW && m >= limit) break;  // the loop guard
    const int rs = max(0, c - top);
    const int re = min(qlen - 1, c + bottom);
    const int letter = a.at[c * B + lane];
    const int* mcol = mat + letter;  // matrix[x][letter] = mcol[x * A]
    const int bnd_uH = -go - c * ge;  // the NW boundary H(-1, c)
    const int f_seed = rs == 0 ? max(bnd_uH - go, LSB - ge) : LSB - ge;
    int ul = c == 0 ? 0 : bnd_uH + ge;  // H(r-1, c-1) of row 0
    int uh = LSB;  // H (masked) of the row above in this column
    int f = LSB;   // F of the row above
    int colmax = NEG2, hre = LSB;
    uint8_t* __restrict__ dcol = dirs + c * col_stride;
    for (int r0 = 0; r0 < qlen; r0 += CHUNK) {
      int ph[CHUNK], pe[CHUNK], ar[CHUNK];
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {  // the previous column, masked
        const int r = r0 + j;
        ar[j] = r < qlen ? aq[r * B] : 0;
        if (c == 0) {
          ph[j] = -go - r * ge;
          pe[j] = LSB;
        } else if (r >= prs && r <= pre) {
          ph[j] = hs[r * B];
          pe[j] = es[r * B];
        } else {
          ph[j] = LSB;
          pe[j] = LSB;
        }
      }
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) {
        const int r = r0 + j;
        if (r < qlen) {
          int h = LSB, e = LSB, fm = LSB;
          if (r >= rs && r <= re) {
            e = max(ph[j] - go, pe[j] - ge);
            const int hp = max(e, ul + mcol[ar[j] * A]);
            f = r == rs ? f_seed : max(uh - go, f - ge);
            h = max(hp, f);
            fm = f;
            hs[r * B] = h;
            es[r * B] = e;
            colmax = max(colmax, h);
            if (r == re) hre = h;
          }
          dcol[r * B] = (uint8_t)((h == e) | ((h == fm) << 1) |
                                  ((e == ph[j] - go) << 2) |
                                  ((fm == uh - go) << 3) |
                                  ((ar[j] == letter) << 4));
          ul = ph[j];
          uh = h;
        }
      }
    }
    // trackers (find_alignment's rules per mode)
    const bool empty = rs > re;
    if (!empty) h_last = hre;
    if (MODE == MODE_SW) {
      if (!empty) m = max(m, colmax);
    } else if (MODE == MODE_HW) {
      m = max(m, h_last);
    } else if (MODE == MODE_OV) {
      m = max(m, max(h_last, c == tlen - 1 && !empty ? colmax : NEG2));
    }
    prs = rs;
    pre = re;
  }
  const int last_col = c > 0 ? c - 1 : 0;

  // the end row: first in-band row of the last executed column equal to
  // the final max
  int endq = BIGR;
  if ((MODE == MODE_SW || MODE == MODE_OV) && c > 0) {
    for (int r = max(0, last_col - top); r <= min(qlen - 1, last_col + bottom);
         ++r) {
      if (hs[r * B] == m) {
        endq = r;
        break;
      }
    }
  }
  const int score = MODE == MODE_NW ? h_last : m;
  int rq, rt;
  bool ok;
  if (MODE == MODE_NW) {
    rq = qlen - 1;
    rt = tlen - 1;
    ok = score == limit;
  } else if (MODE == MODE_HW) {
    rq = qlen - 1;
    rt = last_col;
    ok = score == limit;
  } else {
    rq = endq;
    rt = last_col;
    ok = score == limit && endq < BIGR;
  }
  ok = ok && rq >= 0 && rq < qlen;
  a.score[lane] = score;
  a.rend_q[lane] = rq;
  a.rend_t[lane] = rt;
  a.ok[lane] = ok;

  // ---- walk: tie order E, F, diagonal; a field switch is fused into the
  // first emission of its run; border indels once a coordinate is spent
  int r = ok ? rq : -1, cc = ok ? rt : -1, field = 0;
  uint8_t* __restrict__ codes = a.codes + lane;
  const int half = (a.Qp + a.Tp + 4) / 2;
  for (int s = 0; s < half; ++s) {
    int pair = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool inside = r >= 0 && cc >= 0;
      const int bits = inside ? dirs[cc * col_stride + r * B] : 0;
      const bool b0 = bits & 1, b1 = bits & 2, b2 = bits & 4, b3 = bits & 8;
      const bool fH = inside && field == 0;
      const bool ins_step = (inside && field == 1) || (fH && b0);
      const bool del_step = (inside && field == 2) || (fH && !b0 && b1);
      const bool diag = fH && !b0 && !b1;
      const bool e_open = ins_step && b2 && cc > 0;
      const bool f_open = del_step && b3 && r > 0;
      const bool bdel = !inside && r >= 0;
      const bool bins = !inside && r < 0 && cc >= 0;
      const int code =
          diag ? ((bits & 16) ? ALIGN_MATCH : ALIGN_MISMATCH) + 1
          : (ins_step || bins) ? ALIGN_INS + 1
          : (del_step || bdel) ? ALIGN_DEL + 1
                               : 0;
      if (ins_step) field = 1;
      if (del_step) field = 2;
      if (e_open || f_open || diag) field = 0;
      r -= diag || del_step || bdel;
      cc -= diag || ins_step || bins;
      pair = pair * 5 + code;
    }
    codes[s * B] = (uint8_t)pair;
  }
}

template <int MODE>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = (size_t)a.A * a.A * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        device_fill_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  device_fill_kernel<MODE>
      <<<(a.B + THREADS - 1) / THREADS, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Fills and walks the B lanes of one group on `stream`: one thread per
// lane, one CUDA block per THREADS lanes. hs, es ([Qp, B] int32) and dirs
// ([Tp, Qp, B] uint8) are scratch the caller allocates; the kernel reads
// no scratch it has not written. The caller guarantees 1 <= qlen <= Qp,
// 1 <= tlen <= Tp, 0 <= bottom, top, letters below A and values within
// device_fill.VALUE_BOUND. Returns a cudaError_t (0 on success).
extern "C" int device_fill_launch(
    const void* aq, const void* at, const void* qlen, const void* tlen,
    const void* bottom, const void* top, const void* limit,
    const void* matrix, void* hs, void* es, void* dirs, void* score,
    void* rend_q, void* rend_t, void* ok, void* codes, int Qp, int Tp, int B,
    int A, int mode, int go, int ge, void* stream) {
  if (Qp < 1 || Tp < 1 || B < 1 || A < 1 || A > MAX_A || ge < 0 || ge > go)
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(aq),     static_cast<const int*>(at),
         static_cast<const int*>(qlen),   static_cast<const int*>(tlen),
         static_cast<const int*>(bottom), static_cast<const int*>(top),
         static_cast<const int*>(limit),  static_cast<const int*>(matrix),
         static_cast<int*>(hs),           static_cast<int*>(es),
         static_cast<uint8_t*>(dirs),     static_cast<int*>(score),
         static_cast<int*>(rend_q),       static_cast<int*>(rend_t),
         static_cast<uint8_t*>(ok),       static_cast<uint8_t*>(codes),
         Qp, Tp, B, A, go, ge};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case MODE_NW: return launch<MODE_NW>(a, st);
    case MODE_HW: return launch<MODE_HW>(a, st);
    case MODE_OV: return launch<MODE_OV>(a, st);
    case MODE_SW: return launch<MODE_SW>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
