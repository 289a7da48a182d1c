// strip_group.cuh: the strip-group sweep that ragged_dp.cu and multi_dp.cu
// share (see ragged_dp.cu's header for the design).
//
// A lane's query is cut into strips of R rows. The G threads of a lane's
// group (G = 1, 2, 4 or 8, consecutive threads of one warp) own strips g,
// g + G, g + 2G, ...; a pass of the group covers G consecutive strips. At
// step k of a pass, thread g computes column k - g of its strip: the row
// above comes from thread g - 1 (__shfl_up_sync), which computed that
// column at step k - 1, or, for thread 0, from the wall or from the int2
// scratch [t, lane] the previous pass (or panel) left there. A strip's H
// and E columns live in registers; its profile rows in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sg {

constexpr int R = 16;          // query rows per strip (== STRIP_ROWS)
constexpr int RS = R + 1;      // shared-memory stride per letter (odd)
constexpr int THREADS = 128;   // threads per CUDA block
constexpr int MAX_W = 128;     // profile width bound (int8 letters)
constexpr int MAX_G = 8;       // threads per lane group, at most
constexpr int NEG = -(1 << 30);
constexpr int PAD_NEG = -(1 << 20);
constexpr unsigned FULL = 0xffffffffu;

enum { MODE_NW = 0, MODE_HW = 1, MODE_OV = 2, MODE_SW = 3 };
// where a strip's row above comes from
enum { SRC_WALL = 0, SRC_SCRATCH = 1, SRC_SHUFFLE = 2 };

// One CUDA block of the launch: its database block and its first lane.
// Every CUDA block of one database block has that block's G; a CUDA block
// holds THREADS / G lanes.
struct Job {
  int blk, lane0;
};

// Dynamic shared memory of a launch whose largest group is max_g.
inline size_t smem_bytes(int max_g, int W) {
  return (size_t)max_g * W * RS * sizeof(int);
}

// Stage the profile rows [prow0, prow0 + G * R) into sprof[g][letter][row]
// (rows at or past q_end hold PAD_NEG). Consecutive threads read
// consecutive letters of one row and write with stride RS (odd): no bank
// conflict either way. Every thread of the CUDA block calls it.
__device__ __forceinline__ void stage_profile(int* sprof, const int* profile,
                                              int prow0, int q_end, int G,
                                              int W) {
  __syncthreads();
  for (int i = threadIdx.x; i < G * R * W; i += THREADS) {
    const int rl = i / W, c = i - rl * W;
    const int row = prow0 + rl;
    sprof[((rl / R) * W + c) * RS + rl % R] =
        row < q_end ? profile[(size_t)row * W + c] : PAD_NEG;
  }
  __syncthreads();
}

// What one strip leaves for the group's merge.
struct StripOut {
  int sb, st, sr;        // SW: strip max, its first column and row
  int cm, cr;            // OV: last-column max over real rows, first row
  int lr, lr_c, plrm;    // HW / OV: last-row running max (the last strip)
  int nw;                // NW: H[Q-1][len-1] (the last strip)
};

// Overflow flags, per thread over its strips (order-free: min / max).
struct Flags {
  int ulhp, mine, minf, maxh;
};

// One pass of one thread: its strip (if `mine`) over columns 0..len-1 at
// steps g .. g + len - 1 of `steps` (warp-uniform: every thread of the warp
// runs every step, so the shuffles see the whole warp). r0 is the strip's
// first row in the wall's frame (the segment's or the query's), jl row
// Q-1 within the strip, jv the strip's last real row (flags mask the
// rest). `put` stores the strip's last row at every column into scratch.
template <int MODE, bool END, bool FLAGS>
__device__ __forceinline__ StripOut sweep(
    const int* __restrict__ pbase, const uint32_t* __restrict__ lw,
    int2* __restrict__ scr, int B, int len, int steps, int G, int g,
    bool mine, int src, bool put, bool last, int r0, int jl, int jv, int go,
    int ge, Flags& fl) {
  constexpr bool WALL = MODE == MODE_NW || MODE == MODE_HW;
  StripOut o{0, 0, 0, NEG, 0, NEG, 0, NEG, NEG};
  int H[R], E[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    H[j] = WALL ? -go - (r0 + j) * ge : 0;  // H[r][-1]
    E[j] = MODE == MODE_SW ? 0 : NEG;       // E[r][-1]
  }
  // diagonal input of row r0 at column 0: H[r0-1][-1]
  int ul = (r0 > 0 && WALL) ? -go - (r0 - 1) * ge : 0;
  int hb = 0, fb = 0;  // this strip's last row at its latest column
  uint32_t w = 0;
  for (int k = 0; k < steps; ++k) {
    int hin = 0, fin = 0;
    if (G > 1) {  // the row above, from thread g - 1's previous step
      hin = __shfl_up_sync(FULL, hb, 1, G);
      fin = __shfl_up_sync(FULL, fb, 1, G);
    }
    const int t = k - g;
    if (!mine || t < 0 || t >= len) continue;
    if ((t & 3) == 0) w = __ldg(lw + (size_t)(t >> 2) * B);
    const int* pr = pbase + (w & 0x7f) * RS;
    w >>= 8;
    int hu, fu;  // H[r0-1][t], F[r0-1][t]
    if (src == SRC_SHUFFLE) {
      hu = hin;
      fu = fin;
    } else if (src == SRC_SCRATCH) {
      const int2 b = scr[(size_t)t * B];
      hu = b.x;
      fu = b.y;
    } else {  // row -1: the mode's wall
      hu = MODE == MODE_NW ? -go - t * ge : 0;
      fu = MODE == MODE_SW ? 0 : NEG;
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
      if (FLAGS && j <= jv) {  // real rows only
        if (MODE == MODE_SW) {
          fl.ulhp = max(fl.ulhp, d);
        } else {
          fl.mine = min(fl.mine, e);
          fl.minf = min(fl.minf, f);
          fl.maxh = max(fl.maxh, h);
        }
      }
      diag = H[j];
      H[j] = h;
      E[j] = e;
      hu = h;
      fu = f;
      // Padding rows need no mask here: they repeat real values at most,
      // and only at later rows or columns, so neither the running max nor
      // a strict first improvement can pick them.
      if (MODE == MODE_SW) {
        if (END) {
          if (h > o.sb) {
            o.sb = h;
            o.st = t;
            o.sr = r0 + j;
          }
        } else {
          o.sb = max(o.sb, h);
        }
      }
    }
    hb = hu;
    fb = fu;
    if (put) scr[(size_t)t * B] = make_int2(hu, fu);
    if ((MODE == MODE_HW || MODE == MODE_OV) && last) {
      int v = H[0];
#pragma unroll
      for (int j = 1; j < R; ++j)
        if (j == jl) v = H[j];
      o.plrm = o.lr;  // last-row max before this column
      if (v > o.lr) {
        o.lr = v;
        o.lr_c = t;
      }
    }
  }
  if (!mine || len == 0) return o;
  // H now holds column len-1
  if (MODE == MODE_OV) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if ((!last || j <= jl) && H[j] > o.cm) {
        o.cm = H[j];
        o.cr = r0 + j;
      }
    }
  }
  if (MODE == MODE_NW && last) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j == jl) o.nw = H[j];
  }
  return o;
}

// Thread g2's value of v, for every thread of the group.
__device__ __forceinline__ int from(int v, int g2, int G) {
  return G > 1 ? __shfl_sync(FULL, v, g2, G) : v;
}

// Merge strip g2's SW and OV trackers into the group's, strips in order,
// with the one-thread rules: SW keeps the earlier strip's end on a tie
// unless the later strip reached the value in an earlier column (smallest
// end_t, then smallest end_q); OV's last-column max keeps the earlier
// strip on a tie (its first row). Every thread of the group calls it.
template <int MODE, bool END>
__device__ __forceinline__ void merge_strip(const StripOut& o, int g2, int G,
                                            int& best, int& best_r,
                                            int& best_c, int& ocm,
                                            int& orow) {
  if (MODE == MODE_SW) {
    const int sb = from(o.sb, g2, G);
    if (END) {
      const int st = from(o.st, g2, G), sr = from(o.sr, g2, G);
      if (sb > best || (sb == best && sb > 0 && st < best_c)) {
        best = sb;
        best_c = st;
        best_r = sr;
      }
    } else {
      best = max(best, sb);
    }
  }
  if (MODE == MODE_OV) {
    const int cm = from(o.cm, g2, G), cr = from(o.cr, g2, G);
    if (cm > ocm) {
      ocm = cm;
      orow = cr;
    }
  }
}

// The last-row trackers of strip g2, the strip that holds row Q-1.
template <int MODE>
__device__ __forceinline__ void last_row(const StripOut& o, int g2, int G,
                                         int& lr, int& lr_c, int& plrm,
                                         int& nw) {
  if (MODE == MODE_HW || MODE == MODE_OV) {
    lr = from(o.lr, g2, G);
    lr_c = from(o.lr_c, g2, G);
    plrm = from(o.plrm, g2, G);
  }
  if (MODE == MODE_NW) nw = from(o.nw, g2, G);
}

// Launch kernel k over n_jobs CUDA blocks with smem bytes of dynamic
// shared memory (allowed past 48 KB first); a cudaError_t, 0 on success.
template <typename Kernel, typename Args>
int launch_kernel(Kernel k, const Args& a, int n_jobs, size_t smem,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k<<<n_jobs, THREADS, smem, stream>>>(a);
  return 0;
}

}  // namespace sg
