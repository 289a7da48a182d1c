// device_fill: the alignment fill and backtrace walk of a group of x2
// winners, one pair per lane.
//
// Replaces opal_tpu's _fill_walk_fn (opal_tpu/engine/device_fill.py:90-318,
// XLA lax.scan, not Pallas): per lane, a banded NW-boundary Gotoh DP over
// the reversed prefixes aq [Qp, B] x at [Tp, B] in exact int32, recording
// five decision bits per cell (H == E, H == F, E opened, F opened, match),
// trackers that follow traceback.find_alignment's early stop and end rules
// per mode, and the backtrace walk over those bits. Only the op codes come
// back, two walk steps per byte in base 5 ([(Qp + Tp + 4) / 2, B]).
//
// The mapping: one warp per lane, a column wavefront over its rows (the
// scheme of strip_group.cuh, which ragged_dp and multi_dp share). The
// lane's rows are cut into strips of R rows (R = 16 or 32, a template
// argument that device_fill.plan_fill picks); thread t of the warp owns
// strips t, t + 32, ...; a pass covers 32 consecutive strips. At step k of
// a pass, thread t computes column k - t of its strip:
// - the row above (its masked H and the F chain) comes from thread t - 1 by
//   __shfl_up_sync, or for thread 0 from the wall (pass 0) or from the
//   int2 scratch [B, Tp] that the last thread of the previous pass left;
//   the diagonal H(r0 - 1, c - 1) is what came from above one step before;
// - a strip's H and E of the previous column stay in registers, masked as
//   opal_tpu masks them (LSB outside the band, the NW wall at column 0);
// - the F chain is the plain sequential recurrence F(r) = max(H(r-1) - go,
//   F(r-1) - ge), seeded at the band's first row rs as at opal_tpu's
//   :146-157, wherever rs falls; it equals opal_tpu's max-plus rewrite for
//   ge <= go, which the host driver demands;
// - a thread's R decision-bit bytes of one column are one (R 16) or two
//   (R 32) 16-byte stores into the lane-major [B, Tp, Qp] matrix; bits of
//   rows at or past qlen are never read (the walk starts below qlen).
//
// The loop guard (a column runs while the max before it is below the
// limit; NW has no early stop) under the wavefront: each column's summary
// (in-band max, the first row reaching it, H at the band's last row re)
// goes down the warp with H and F, so the last thread holds it complete,
// in column order, 31 steps after thread 0 began that column. In the
// lane's last pass that thread applies opal_tpu's tracker rules (:178-201)
// column by column, exactly, and stops the warp (__shfl_sync) once the
// guard trips: the columns up to 31 past the stop that the other threads
// computed are never read by the walk. An earlier pass (qlen > 32 R) merges
// its partial summaries into a [B, Tp] int4 scratch and stops as soon as
// they prove the trip (a lower bound on the max at or above the limit); the
// next pass runs no further than that column.
//
// The end row (SW, OV) is the first in-band row of the last executed
// column equal to the final max m: the first row of that column's max when
// the max equals m, none when it is below. In OV the column may hold values
// above m; then the warp runs the fill once more up to that column without
// bits (PROBE), with the summary taken over the cells equal to m.
//
// The walk stays serial: every thread of the warp steps the same path over
// the lane-major bits (tie order E, F, diagonal; a field switch is fused
// into the first emission of its run; border indels once a coordinate is
// spent), reading a shared-memory tile of 32 columns x 80 rows that the
// warp loads at once whenever the path leaves it, so a step does not wait
// on a global load.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // lanes per CUDA block
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_A = 128;  // alphabet bound (kernels.MAX_ALPHABET)
constexpr int TILE_ROWS = 80;  // rows of a warp's walk tile (32 columns)
constexpr int TILE_BYTES = WARPS * 32 * TILE_ROWS;
constexpr int LSB = -(1 << 30);
constexpr int NEG2 = LSB - (1 << 24);
constexpr int BIGR = 1 << 24;
constexpr unsigned FULL = 0xffffffffu;
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
  int2* scr;          // [B, Tp] scratch: a pass's last row (H, F)
  int4* sums;         // [B, Tp] scratch: column summaries of earlier passes
  uint8_t* dirs;      // [B, Tp, Qp] decision bits
  int* score;         // [B]
  int* rend_q;        // [B] end of the reversed problem
  int* rend_t;        // [B]
  uint8_t* ok;        // [B] bool
  uint8_t* codes;     // [(Qp + Tp + 4) / 2, B]
  int Qp, Tp, B, A, go, ge;
};

// One lane's problem, the same in every thread of its warp.
struct Lane {
  const int* aq;      // the lane's column of aq: row r at aq[r * B]
  const int* at;      // likewise at
  const int* mat;     // [A, A] in shared memory
  int2* scr;          // the lane's [Tp] rows of the scratches
  int4* sums;
  uint8_t* dirs;      // the lane's [Tp, Qp] bits
  int qlen, tlen, bottom, top, limit, go, ge, A, Qp, B;
};

// The last thread's trackers after a fill: m, H at the band's last row of
// the latest non-empty column, the executed columns, and the last executed
// column's summary (its max and the first row reaching it).
struct Track {
  int m, h_last, cols, lcm, lcr;
};

// The fill of one lane by its warp. PROBE runs columns 0 .. probe_col with
// no guard and no bits, and takes each column's summary over the in-band
// cells equal to pv: tr.lcm == pv and tr.lcr its first row when probe_col
// holds one. Every thread of the warp calls it; tr is the last thread's.
template <int MODE, int R, bool PROBE>
__device__ __forceinline__ void fill(const Lane& L, int probe_col, int pv,
                                     Track& tr) {
  const int t = threadIdx.x & 31;
  const int go = L.go, ge = L.ge, A = L.A;
  const int npass = max(1, (L.qlen + 32 * R - 1) / (32 * R));
  int ncols = PROBE ? probe_col + 1 : L.tlen;
  tr = Track{NEG2, LSB, 0, NEG2, BIGR};
  for (int p = 0; p < npass; ++p) {
    const bool lastp = p == npass - 1;
    const int r0 = (p * 32 + t) * R;
    const bool mine = r0 < L.qlen;
    uint32_t arp[R / 4];  // the strip's letters, four to a word
    int H[R], E[R];       // the previous column, masked
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int x = mine && r0 + j < L.qlen ? L.aq[(size_t)(r0 + j) * L.B]
                                            : 0;
      if ((j & 3) == 0) arp[j >> 2] = 0;
      arp[j >> 2] |= (uint32_t)x << ((j & 3) * 8);
      H[j] = -go - (r0 + j) * ge;  // column -1: the NW wall
      E[j] = LSB;
    }
    int ul = r0 == 0 ? 0 : -go - (r0 - 1) * ge;  // H(r0 - 1, c - 1)
    int hb = LSB, fb = LSB;  // the strip's last row at its latest column
    int ocm = NEG2, ocr = BIGR, ore = LSB;  // its column summary so far
    int lb = NEG2;  // a lower bound on m (earlier passes, last thread)
    bool stop = false;  // the last thread's: no further column is needed
    if (!PROBE && lastp && MODE != MODE_NW) stop = tr.m >= L.limit;
    const int steps = ncols + 31;
    int k = 0;
    int letter = mine ? __ldg(L.at) : 0;  // column 0's, then prefetched
    for (; k < steps; ++k) {
      const int hin = __shfl_up_sync(FULL, hb, 1);
      const int fin = __shfl_up_sync(FULL, fb, 1);
      const int cmin = __shfl_up_sync(FULL, ocm, 1);
      const int crin = __shfl_up_sync(FULL, ocr, 1);
      const int rein = __shfl_up_sync(FULL, ore, 1);
      if (__shfl_sync(FULL, (int)stop, 31)) break;
      const int c = k - t;
      if (c < 0 || c >= ncols) continue;
      int hu, fu;  // H (masked) and F of row r0 - 1 in column c
      if (t > 0) {
        hu = hin;
        fu = fin;
        ocm = cmin;
        ocr = crin;
        ore = rein;
      } else {
        if (p == 0) {
          hu = LSB;  // row -1 lies outside every band
          fu = LSB;
        } else {
          const int2 s = L.scr[c];
          hu = s.x;
          fu = s.y;
        }
        ocm = NEG2;
        ocr = BIGR;
        ore = LSB;
      }
      const int rs = max(0, c - L.top);
      const int re = min(L.qlen - 1, c + L.bottom);
      if (mine) {
        const int let = letter;
        if (c + 1 < ncols) letter = __ldg(L.at + (size_t)(c + 1) * L.B);
        const int* mcol = L.mat + let;  // matrix[x][let] = mcol[x * A]
        const int bnd_uH = -go - c * ge;  // the NW wall H(-1, c)
        const int f_seed = rs == 0 ? max(bnd_uH - go, LSB - ge) : LSB - ge;
        int diag = r0 == 0 ? (c == 0 ? 0 : bnd_uH + ge) : ul;
        ul = hu;
        int uh = hu, f = fu;
        uint32_t bw[R / 4];
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = r0 + j;
          const int x = (arp[j >> 2] >> ((j & 3) * 8)) & 0xff;
          const int ph = H[j];
          const bool inb = r >= rs && r <= re;
          const int e = max(ph - go, E[j] - ge);
          const int hp = max(e, diag + mcol[x * A]);
          const int fn = r == rs ? f_seed : max(uh - go, f - ge);
          const int h = max(hp, fn);
          const int hm = inb ? h : LSB;
          const int em = inb ? e : LSB;
          const int fm = inb ? fn : LSB;
          const uint32_t bits = (uint32_t)(hm == em) |
                                ((uint32_t)(hm == fm) << 1) |
                                ((uint32_t)(em == ph - go) << 2) |
                                ((uint32_t)(fm == uh - go) << 3) |
                                ((uint32_t)(x == let) << 4);
          if ((j & 3) == 0) bw[j >> 2] = 0;
          bw[j >> 2] |= bits << ((j & 3) * 8);
          diag = ph;
          H[j] = hm;
          E[j] = em;
          uh = hm;
          f = fn;
          if (inb) {
            const int hv = PROBE ? (h == pv ? h : NEG2) : h;
            if (hv > ocm) {  // strict: the first row reaching the max
              ocm = hv;
              ocr = r;
            }
            if (r == re) ore = h;
          }
        }
        hb = uh;
        fb = f;
        if (!PROBE) {
          uint4* d = reinterpret_cast<uint4*>(
              L.dirs + (size_t)c * L.Qp + r0);
#pragma unroll
          for (int v = 0; v < R / 16; ++v)
            d[v] = make_uint4(bw[4 * v], bw[4 * v + 1], bw[4 * v + 2],
                              bw[4 * v + 3]);
        }
      }
      if (t == 31) {  // column c's summary is complete for this pass
        int cm = ocm, cr = ocr, hre = ore;
        if (p > 0) {  // merge the earlier passes' rows (they come first)
          const int4 s = L.sums[c];
          if (s.x >= cm) {
            cm = s.x;
            cr = s.y;
          }
          hre = max(hre, s.z);
        }
        const bool empty = rs > re;
        if (!lastp) {
          L.sums[c] = make_int4(cm, cr, hre, 0);
          L.scr[c] = make_int2(hb, fb);
          if (!PROBE && MODE != MODE_NW) {
            if (MODE == MODE_SW) lb = max(lb, cm);
            else if (!empty && hre != LSB) lb = max(lb, hre);
            stop = lb >= L.limit;
          }
        } else if (PROBE) {
          if (c == probe_col) {
            tr.lcm = cm;
            tr.lcr = cr;
          }
        } else {  // find_alignment's trackers, column by column
          if (!empty) tr.h_last = hre;
          if (MODE == MODE_SW) {
            if (!empty) tr.m = max(tr.m, cm);
          } else if (MODE == MODE_HW) {
            tr.m = max(tr.m, tr.h_last);
          } else if (MODE == MODE_OV) {
            tr.m = max(tr.m, max(tr.h_last,
                                 c == L.tlen - 1 && !empty ? cm : NEG2));
          }
          tr.lcm = cm;
          tr.lcr = cr;
          if (MODE != MODE_NW) stop = tr.m >= L.limit;
        }
      }
    }
    // columns the next pass needs, or this pass executed (warp-uniform)
    ncols = k < steps ? max(0, k - 31) : ncols;
    __syncwarp();  // the scratch rows are visible to thread 0
  }
  tr.cols = ncols;
}

template <int MODE, int R>
__global__ void __launch_bounds__(THREADS, 1) device_fill_kernel(Args a) {
  extern __shared__ uint4 smem[];  // the walk's tiles, then [A, A]
  uint8_t* tiles = reinterpret_cast<uint8_t*>(smem);
  int* mat = reinterpret_cast<int*>(tiles + TILE_BYTES);
  for (int i = threadIdx.x; i < a.A * a.A; i += THREADS) mat[i] = a.matrix[i];
  __syncthreads();
  const int lane = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (lane >= a.B) return;  // the whole warp
  const int t = threadIdx.x & 31;

  Lane L;
  L.aq = a.aq + lane;
  L.at = a.at + lane;
  L.mat = mat;
  L.scr = a.scr + (size_t)lane * a.Tp;
  L.sums = a.sums + (size_t)lane * a.Tp;
  L.dirs = a.dirs + (size_t)lane * a.Tp * a.Qp;
  L.qlen = a.qlen[lane];
  L.tlen = a.tlen[lane];
  L.bottom = a.bottom[lane];
  L.top = a.top[lane];
  L.limit = a.limit[lane];
  L.go = a.go;
  L.ge = a.ge;
  L.A = a.A;
  L.Qp = a.Qp;
  L.B = a.B;

  Track tr;
  fill<MODE, R, false>(L, 0, 0, tr);
  const int cols = tr.cols;
  const int m = tr.m;
  const int last_col = cols > 0 ? cols - 1 : 0;
  // the end row: the first in-band row of the last executed column equal
  // to m; only OV's column can hold values above m
  int endq = BIGR;
  if ((MODE == MODE_SW || MODE == MODE_OV) && cols > 0 && tr.lcm == m)
    endq = tr.lcr;
  const bool probe = __shfl_sync(
      FULL, (int)(MODE == MODE_OV && cols > 0 && tr.lcm > m), 31);
  if (MODE == MODE_OV && probe) {
    Track pr;
    fill<MODE, R, true>(L, last_col, __shfl_sync(FULL, m, 31), pr);
    if (pr.lcm == m) endq = pr.lcr;
  }
  __syncwarp();  // every thread's bits are visible to the walk

  const int score = MODE == MODE_NW ? tr.h_last : m;
  const int qlen = L.qlen, tlen = L.tlen, limit = L.limit;
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
  if (t == 31) {
    a.score[lane] = score;
    a.rend_q[lane] = rq;
    a.rend_t[lane] = rt;
    a.ok[lane] = ok;
  }
  ok = __shfl_sync(FULL, (int)ok, 31);
  rq = __shfl_sync(FULL, rq, 31);
  rt = __shfl_sync(FULL, rt, 31);

  // ---- walk: tie order E, F, diagonal; a field switch is fused into the
  // first emission of its run; border indels once a coordinate is spent.
  // Every thread steps the same path; the warp loads the bits of the 32
  // columns left of the current cell, TILE_ROWS rows above it, into its
  // shared tile at once, so a step reads shared memory, and only a step
  // that leaves the tile waits for the next load.
  uint8_t* tile = tiles + (threadIdx.x >> 5) * (32 * TILE_ROWS);
  const uint8_t* __restrict__ dirs = L.dirs;
  const size_t B = a.B;
  int r = ok ? rq : -1, cc = ok ? rt : -1, field = 0;
  int wr0 = 0, wc0 = 0;
  bool loaded = false;
  uint8_t* __restrict__ codes = a.codes + lane;
  const int half = (a.Qp + a.Tp + 4) / 2;
  for (int s = 0; s < half; ++s) {
    int pair = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool inside = r >= 0 && cc >= 0;
      if (inside && !(loaded && r >= wr0 && r < wr0 + TILE_ROWS &&
                      cc >= wc0)) {  // warp-uniform: the same path
        wr0 = max(0, r - (TILE_ROWS - 17)) & ~15;
        wc0 = cc - 31;
        __syncwarp();
        const int cw = wc0 + t;
        if (cw >= 0) {
          const uint4* src =
              reinterpret_cast<const uint4*>(dirs + (size_t)cw * a.Qp + wr0);
          uint4* dst = reinterpret_cast<uint4*>(tile + t * TILE_ROWS);
#pragma unroll
          for (int v = 0; v < TILE_ROWS / 16; ++v)
            if (wr0 + 16 * v < a.Qp) dst[v] = src[v];
        }
        __syncwarp();
        loaded = true;
      }
      const int bits = inside ? tile[(cc - wc0) * TILE_ROWS + r - wr0] : 0;
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
    if (t == 0) codes[s * B] = (uint8_t)pair;
  }
}

template <int MODE, int R>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = TILE_BYTES + (size_t)a.A * a.A * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        device_fill_kernel<MODE, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  device_fill_kernel<MODE, R>
      <<<(a.B + WARPS - 1) / WARPS, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int R>
int launch_mode(const Args& a, int mode, cudaStream_t st) {
  switch (mode) {
    case MODE_NW: return launch<MODE_NW, R>(a, st);
    case MODE_HW: return launch<MODE_HW, R>(a, st);
    case MODE_OV: return launch<MODE_OV, R>(a, st);
    case MODE_SW: return launch<MODE_SW, R>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Fills and walks the B lanes of one group on `stream`: one warp per lane,
// WARPS lanes per CUDA block, strips of `rows` (16 or 32) query rows. scr
// ([B, Tp] int2), sums ([B, Tp] int4) and dirs ([B, Tp, Qp] uint8) are
// scratch the caller allocates; scr and sums are touched only when a
// lane's qlen passes 32 * rows (device_fill.plan_fill sizes them), and the
// kernel reads no scratch it has not written. The caller guarantees
// 1 <= qlen <= Qp, 1 <= tlen <= Tp, Qp a multiple of 64, 0 <= bottom, top,
// letters below A and values within device_fill.VALUE_BOUND. Returns a
// cudaError_t (0 on success).
extern "C" int device_fill_launch(
    const void* aq, const void* at, const void* qlen, const void* tlen,
    const void* bottom, const void* top, const void* limit,
    const void* matrix, void* scr, void* sums, void* dirs, void* score,
    void* rend_q, void* rend_t, void* ok, void* codes, int Qp, int Tp, int B,
    int A, int mode, int go, int ge, int rows, void* stream) {
  if (Qp < 1 || Qp % 64 || Tp < 1 || B < 1 || A < 1 || A > MAX_A ||
      ge < 0 || ge > go || (rows != 16 && rows != 32))
    return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int*>(aq),     static_cast<const int*>(at),
         static_cast<const int*>(qlen),   static_cast<const int*>(tlen),
         static_cast<const int*>(bottom), static_cast<const int*>(top),
         static_cast<const int*>(limit),  static_cast<const int*>(matrix),
         static_cast<int2*>(scr),         static_cast<int4*>(sums),
         static_cast<uint8_t*>(dirs),     static_cast<int*>(score),
         static_cast<int*>(rend_q),       static_cast<int*>(rend_t),
         static_cast<uint8_t*>(ok),       static_cast<uint8_t*>(codes),
         Qp, Tp, B, A, go, ge};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == 16 ? launch_mode<16>(a, mode, st)
                    : launch_mode<32>(a, mode, st);
}
