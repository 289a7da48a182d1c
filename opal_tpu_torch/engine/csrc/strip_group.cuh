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
//
// The probes of opal_tpu_torch/tools/csrc (exp_unroll, exp_sstack) run
// this sweep with other column bodies (Body: strip heights, DPX forms, a
// folded tracker, several chains per thread), to ablate this one.
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

// Stage the profile rows [prow0, prow0 + G * RR) into
// sprof[g][letter][row] (rows at or past q_end hold PAD_NEG), in strips of
// RR rows (R, except in the probes). Consecutive threads read consecutive
// letters of one row and write with stride RR + 1 (odd): no bank conflict
// either way. Every thread of the CUDA block calls it.
template <int RR = R>
__device__ __forceinline__ void stage_profile(int* sprof, const int* profile,
                                              int prow0, int q_end, int G,
                                              int W) {
  constexpr int RSV = RR + 1;
  __syncthreads();
  for (int i = threadIdx.x; i < G * RR * W; i += THREADS) {
    const int rl = i / W, c = i - rl * W;
    const int row = prow0 + rl;
    sprof[((rl / RR) * W + c) * RSV + rl % RR] =
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

// The column body of a sweep (its V). ragged_dp and multi_dp run the
// default; the probes of opal_tpu_torch/tools/csrc ablate the others on
// the same wavefront, SW score-only:
//   RR      - query rows per strip;
//   DPX     - E and F by __viaddmax_s32, H by __vimax3_s32_relu;
//   FOLD    - the score tracker folded over two rows: one max3 per two
//             cells (rows 2i and 2i + 1 of a column);
//   NOPROF  - every letter scores as letter 0, whose column the thread
//             holds in registers: no letter loads, no profile lookups;
//   CHAINS  - independent dependence chains per thread and step, their
//             values a Vec: CHAINS lanes on the same strip (chain c's
//             letters and scratch at c x Chains::lw / Chains::scr past
//             chain 0's), or, with STRIPS2, two adjacent strips of one
//             lane, the lower one a column behind the upper, whose last
//             row of the previous step is its row above.
template <int RR_ = R, bool DPX_ = false, bool FOLD_ = false,
          int CHAINS_ = 1, bool STRIPS2_ = false, bool NOPROF_ = false>
struct Body {
  static constexpr int RR = RR_, CHAINS = CHAINS_;
  static constexpr bool DPX = DPX_, FOLD = FOLD_, STRIPS2 = STRIPS2_,
                        NOPROF = NOPROF_;
};

// Where chain c of a thread finds its data: c times these past chain 0's;
// pad: RR profile values of PAD_NEG (STRIPS2 scores a strip's column
// before its first and after its last against them).
struct Chains {
  size_t lw, scr;  // letter words, scratch cells (CHAINS lanes)
  int prof;        // profile ints (STRIPS2: one staged strip)
  const int* pad;
};

// What a sweep reports per column and chain (tap(chain, column, running
// best)); the default reports nothing.
struct NoTap {
  __device__ __forceinline__ void operator()(int, int, int) const {}
};

// One value per chain of a thread, where a Body runs several: the
// operators the column body uses act chain by chain (hidden friends, so
// plain ints keep the global max).
template <int C, class T>
struct Vec {
  T v[C];
  __device__ __forceinline__ Vec() {}
  __device__ __forceinline__ Vec(T a) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = a;
  }
  __device__ __forceinline__ T& operator[](int c) { return v[c]; }
  __device__ __forceinline__ const T& operator[](int c) const {
    return v[c];
  }
  friend __device__ __forceinline__ Vec operator+(Vec a, const Vec& b) {
#pragma unroll
    for (int c = 0; c < C; ++c) a.v[c] += b.v[c];
    return a;
  }
  friend __device__ __forceinline__ Vec operator-(Vec a, T b) {
#pragma unroll
    for (int c = 0; c < C; ++c) a.v[c] -= b;
    return a;
  }
  friend __device__ __forceinline__ Vec max(Vec a, const Vec& b) {
#pragma unroll
    for (int c = 0; c < C; ++c) a.v[c] = max(a.v[c], b.v[c]);
    return a;
  }
  friend __device__ __forceinline__ Vec max(Vec a, T b) {
#pragma unroll
    for (int c = 0; c < C; ++c) a.v[c] = max(a.v[c], b);
    return a;
  }
};

// T for one chain, Vec<C, T> for C
template <int C, class T = int>
struct Lanes {
  using type = Vec<C, T>;
};
template <class T>
struct Lanes<1, T> {
  using type = T;
};

// One pass of one thread: its strip (if `mine`) over columns 0..len-1 at
// steps g .. g + len - 1 of `steps` (warp-uniform: every thread of the warp
// runs every step, so the shuffles see the whole warp). r0 is the strip's
// first row in the wall's frame (the segment's or the query's), jl row
// Q-1 within the strip, jv the strip's last real row (flags mask the
// rest). `put` stores the strip's last row at every column into scratch.
// ragged_dp and multi_dp run the default Body, whose chain-specific
// branches are the one-chain code; the probes pass another V, the chains'
// offsets x and a tap. With STRIPS2 a thread's upper strip runs at steps
// 2g .., its lower one a step later, and the lower one puts; each scores
// one more column against x.pad (the upper after its last, the lower
// before its first), which changes no SW score: such a column's H is
// below the strip's best, and the lower strip's H stays 0.
template <int MODE, bool END, bool FLAGS, class V = Body<>,
          class Tap = NoTap>
__device__ __forceinline__ StripOut sweep(
    const int* __restrict__ pbase, const uint32_t* __restrict__ lw,
    int2* __restrict__ scr, int B, int len, int steps, int G, int g,
    bool mine, int src, bool put, bool last, int r0, int jl, int jv, int go,
    int ge, Flags& fl, Chains x = {}, Tap tap = {}) {
  constexpr int RR = V::RR, C = V::CHAINS;
  static_assert(!V::STRIPS2 || C == 2, "two strips are two chains");
  static_assert((C == 1 && RR == R && !V::DPX && !V::FOLD && !V::NOPROF) ||
                    (MODE == MODE_SW && !END && !FLAGS),
                "the probes' bodies are SW score-only");
  static_assert(C == 1 || (!V::DPX && !V::FOLD), "DPX and FOLD: one chain");
  using I = typename Lanes<C>::type;  // a value of every chain
  constexpr bool WALL = MODE == MODE_NW || MODE == MODE_HW;
  StripOut o{0, 0, 0, NEG, 0, NEG, 0, NEG, NEG};
  I H[RR], E[RR];
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    H[j] = WALL ? -go - (r0 + j) * ge : 0;  // H[r][-1]
    E[j] = MODE == MODE_SW ? 0 : NEG;       // E[r][-1]
  }
  // diagonal input of row r0 at column 0: H[r0-1][-1]
  I ul = (r0 > 0 && WALL) ? -go - (r0 - 1) * ge : 0;
  I hb = 0, fb = 0;  // this strip's last row at its latest column
  typename Lanes<V::STRIPS2 ? 1 : C, uint32_t>::type w = 0;
  // the probes': the chains' SW running bests past chain 0's (o.sb), the
  // strip's letter-0 column (NOPROF), the upper strip's previous letter
  // (STRIPS2: the lower strip's letter)
  [[maybe_unused]] I sb = 0;
  [[maybe_unused]] I pc[V::NOPROF ? RR : 1];
  [[maybe_unused]] uint32_t lo = 0;
  if constexpr (V::NOPROF) {
#pragma unroll
    for (int j = 0; j < RR; ++j) {
      if constexpr (C == 1) {
        pc[j] = pbase[j];
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) pc[j][c] = pbase[c * x.prof + j];
      }
    }
  }
  for (int k = 0; k < steps; ++k) {
    I hin = 0, fin = 0;
    if (G > 1) {  // the row above, from thread g - 1's previous step
      if constexpr (C == 1) {
        hin = __shfl_up_sync(FULL, hb, 1, G);
        fin = __shfl_up_sync(FULL, fb, 1, G);
      } else if constexpr (V::STRIPS2) {  // its lower strip's
        hin[0] = __shfl_up_sync(FULL, hb[1], 1, G);
        fin[0] = __shfl_up_sync(FULL, fb[1], 1, G);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          hin[c] = __shfl_up_sync(FULL, hb[c], 1, G);
          fin[c] = __shfl_up_sync(FULL, fb[c], 1, G);
        }
      }
    }
    int t;  // the (upper) strip's column
    if constexpr (V::STRIPS2) {
      // the lower strip's row above: the upper one's previous step
      hin[1] = hb[0];
      fin[1] = fb[0];
      t = k - 2 * g;
      if (!mine || t < 0 || t > len) continue;
    } else {
      t = k - g;
      if (!mine || t < 0 || t >= len) continue;
    }
    typename Lanes<C, const int*>::type pr;  // the columns' profile rows
    if constexpr (V::NOPROF) {
    } else if constexpr (C == 1) {
      if ((t & 3) == 0) w = __ldg(lw + (size_t)(t >> 2) * B);
      pr = pbase + (w & 0x7f) * (RR + 1);
      w >>= 8;
    } else if constexpr (V::STRIPS2) {  // the lower strip: letter t - 1
      uint32_t up = 0;
      if (t < len) {
        if ((t & 3) == 0) w = __ldg(lw + (size_t)(t >> 2) * B);
        up = w & 0x7f;
        w >>= 8;
      }
      pr[0] = t < len ? pbase + up * (RR + 1) : x.pad;
      pr[1] = t > 0 ? pbase + x.prof + lo * (RR + 1) : x.pad;
      lo = up;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if ((t & 3) == 0) w[c] = __ldg(lw + c * x.lw + (size_t)(t >> 2) * B);
        pr[c] = pbase + (w[c] & 0x7f) * (RR + 1);
        w[c] >>= 8;
      }
    }
    I hu, fu;  // H[r0-1][t], F[r0-1][t]
    if (src == SRC_SHUFFLE) {
      hu = hin;
      fu = fin;
    } else if (src == SRC_SCRATCH) {
      if constexpr (C == 1) {
        const int2 b = scr[(size_t)t * B];
        hu = b.x;
        fu = b.y;
      } else {
#pragma unroll
        for (int c = 0; c < (V::STRIPS2 ? 1 : C); ++c) {
          const int2 b = V::STRIPS2 && t >= len
                             ? make_int2(0, 0)
                             : scr[c * x.scr + (size_t)t * B];
          hu[c] = b.x;
          fu[c] = b.y;
        }
      }
    } else {  // row -1: the mode's wall
      if constexpr (C == 1) {
        hu = MODE == MODE_NW ? -go - t * ge : 0;
      } else {
        hu = 0;
      }
      fu = MODE == MODE_SW ? 0 : NEG;
    }
    if constexpr (V::STRIPS2) {
      hu[1] = hin[1];
      fu[1] = fin[1];
    }
    I diag = ul;
    ul = hu;
#pragma unroll
    for (int j = 0; j < RR; ++j) {
      [[maybe_unused]] const I hup = hu;  // the row above's H (FOLD)
      I e, f;
      if constexpr (V::DPX) {
        e = __viaddmax_s32(E[j], -ge, H[j] - go);
        f = __viaddmax_s32(fu, -ge, hu - go);
      } else {
        e = max(H[j] - go, E[j] - ge);
        f = max(hu - go, fu - ge);
      }
      I d;  // ulH + P
      if constexpr (V::NOPROF) {
        d = diag + pc[j];
      } else if constexpr (C == 1) {
        d = diag + pr[j];
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = diag[c] + pr[c][j];
      }
      I h;
      if constexpr (V::DPX) {
        h = __vimax3_s32_relu(e, f, d);
      } else {
        h = max(max(e, f), d);
        if (MODE == MODE_SW) h = max(h, 0);
      }
      // Above 16 rows the fully unrolled body compiled wrong with nvcc
      // 12.8 for sm_90a: at 24 and 32 rows the SW best came out 1 too high
      // on lanes whose strip holds 24 or more padding rows. Pinning h in a
      // register (an empty asm) makes it exact.
      if constexpr (RR > 16) asm volatile("" : "+r"(h));
      if (FLAGS && j <= jv) {  // real rows only
        if constexpr (C == 1) {
          if (MODE == MODE_SW) {
            fl.ulhp = max(fl.ulhp, d);
          } else {
            fl.mine = min(fl.mine, e);
            fl.minf = min(fl.minf, f);
            fl.maxh = max(fl.maxh, h);
          }
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
          if constexpr (C == 1) {
            if (h > o.sb) {
              o.sb = h;
              o.st = t;
              o.sr = r0 + j;
            }
          }
        } else if constexpr (V::FOLD) {
          if (j & 1) o.sb = __vimax3_s32(o.sb, hup, h);
        } else if constexpr (C == 1) {
          o.sb = max(o.sb, h);
        } else {
          sb = max(sb, h);
        }
      }
    }
    hb = hu;
    fb = fu;
    if constexpr (C == 1) {
      if (put) scr[(size_t)t * B] = make_int2(hu, fu);
    } else if constexpr (V::STRIPS2) {  // the lower strip, at t - 1
      if (put && t > 0 && t <= len)
        scr[(size_t)(t - 1) * B] = make_int2(hu[1], fu[1]);
    } else if (put) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        scr[c * x.scr + (size_t)t * B] = make_int2(hu[c], fu[c]);
    }
    if ((MODE == MODE_HW || MODE == MODE_OV) && last) {
      if constexpr (C == 1) {
        int v = H[0];
#pragma unroll
        for (int j = 1; j < RR; ++j)
          if (j == jl) v = H[j];
        o.plrm = o.lr;  // last-row max before this column
        if (v > o.lr) {
          o.lr = v;
          o.lr_c = t;
        }
      }
    }
    if constexpr (C == 1) {
      tap(0, t, o.sb);
    } else if constexpr (V::STRIPS2) {
      if (t < len) tap(0, t, sb[0]);
      if (t > 0) tap(1, t - 1, sb[1]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) tap(c, t, sb[c]);
    }
  }
  if constexpr (C > 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) o.sb = max(o.sb, sb[c]);
  }
  if (!mine || len == 0) return o;
  // H now holds column len-1
  if constexpr (C == 1) {
    if (MODE == MODE_OV) {
#pragma unroll
      for (int j = 0; j < RR; ++j) {
        if ((!last || j <= jl) && H[j] > o.cm) {
          o.cm = H[j];
          o.cr = r0 + j;
        }
      }
    }
    if (MODE == MODE_NW && last) {
#pragma unroll
      for (int j = 0; j < RR; ++j)
        if (j == jl) o.nw = H[j];
    }
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

// out[3]: resident CUDA blocks per SM of kernel k at smem bytes of dynamic
// shared memory, its registers and local (spill) bytes per thread; a
// cudaError_t, 0 on success.
template <typename Kernel>
int kernel_attrs(Kernel k, size_t smem, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, k);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k, THREADS,
                                                      smem);
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)err;
}

}  // namespace sg
