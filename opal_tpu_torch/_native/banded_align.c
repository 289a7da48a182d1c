/* Banded alignment-reconstruction DP + backtrace for opal_tpu_torch (a copy
 * of opal_tpu/_native/banded_align.c; the port keeps its own).
 *
 * C twin of traceback.find_alignment (itself a port of the reference's
 * findAlignment, reference: src/opal.cpp:1236-1431): NW-anchored banded DP
 * with mode-specific stop rules and early stop at score_limit, then a
 * backtrace preferring E over F over the diagonal on ties. The per-pair
 * work is small, irregular and early-stopping — host territory — but
 * NumPy's per-column call overhead dominates in Python, hence this C hot
 * path. Semantics identical to the Python fallback.
 *
 * Memory: unlike the reference, which stores the full Q*T cell matrix
 * (src/opal.cpp:1263 — its main long-sequence scaling weakness, see
 * SURVEY.md §5), storage here is band-relative when the band is narrower
 * than the matrix: cell (r, c) lives at (c*rows + (r - c*step + off)) with
 * (step=1, off=top, rows=top+bottom+1) banded or (step=0, off=0, rows=Q)
 * full. O(band * T) instead of O(Q * T), bit-identical outputs. The
 * within-column index is the MINOR axis so the hot row walk is stride-1.
 *
 * CHECKPOINTED MODE (ck > 0): for pairs whose band area exceeds the
 * caller's memory budget, only every ck-th column (c = m*ck - 1) is kept
 * as a checkpoint and the fill streams through a ck-column ring window;
 * the backtrace re-derives each ck-column block it walks into by re-running
 * the fill from the preceding checkpoint. Because the fill's column carry
 * lives in hbuf/ebuf (it never reads the stored matrices), the recompute
 * is the SAME code path and the outputs are bit-identical to full storage.
 * Memory O(band * (ck + T/ck)) — O(band * sqrt(T)) at ck ~ sqrt(T) — and
 * recompute adds at most one extra fill's worth of work along the path.
 * This removes the reference's O(Q*T) traceback-memory ceiling entirely.
 *
 * Fill-speed design:
 *   1. stride-1 column-major-in-band layout (above);
 *   2. the previous column's H/E carried in small L1 scratch, so the big
 *      matrices are streaming-store-only during the fill;
 *   3. per-pair query profile (gated) instead of per-cell 2D gathers;
 *   4. two-pass columns: a vectorizable E/H-candidate pass, then the F
 *      chain — which for ge <= go takes an exact max-plus prefix-scan
 *      form computed in 16-lane AVX-512 blocks, breaking the ~4-cycle
 *      serial F dependency that otherwise binds the whole fill.
 *
 * Sentinel: LSB = INT32_MIN/2 + max(go, ge). Derived values are
 * LSB - k*ge - j*go with bounded k, j, so no wraparound is possible (unlike
 * the reference's INT_MIN-based sentinel, which wraps when go == ge);
 * equality comparisons between sentinel-derived values are invariant under
 * the sentinel shift, so outputs match the reference wherever it is
 * well-defined.
 *
 * Returns 0 on success, -1 if the end location is not found (caller falls
 * back), -2 if the backtrace fails, -3 on allocation failure.
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

#define MODE_NW 0
#define MODE_HW 1
#define MODE_OV 2
#define MODE_SW 3

#define OP_MATCH 0
#define OP_DEL 1
#define OP_INS 2
#define OP_MISMATCH 3

static inline int32_t max32(int32_t a, int32_t b) { return a > b ? a : b; }

/* Shared fill inputs + column-carry state. */
typedef struct {
    const uint8_t *query;
    const uint8_t *target;
    int64_t Q, T;
    int32_t go, ge;
    const int32_t *matrix;
    int64_t alpha;
    int32_t mode;
    int64_t bottom, top, step, off, rows;
    const int32_t *prof;   /* [alpha*Q] letter-major profile, or NULL */
    const int32_t *ramp;   /* [Q] i*ge decay ramp for the F scan */
    int32_t *hbuf, *ebuf;  /* prev column's final H/E by ABSOLUTE row */
    int32_t *htmp;         /* staging for pass 1's F-less H candidates */
    int32_t LSB;
} fa_ctx;

/* Fill DP column c into the provided column slices (each x->rows long;
 * within-column offset (r - c*step + off)). Reads the previous column
 * from hbuf/ebuf (band-checked), writes this column to the slices AND to
 * hbuf/ebuf, and merges the mode-specific trackers into *max_score /
 * *H_last. Never reads the stored matrices, so re-running it from a
 * restored carry reproduces any column range bit-exactly (checkpointing).
 */
static void fill_column(const fa_ctx *x, int64_t c,
                        int32_t *restrict Hcol, int32_t *restrict Ecol,
                        int32_t *restrict Fcol,
                        int32_t *max_score, int32_t *H_last)
{
    const int32_t go = x->go, ge = x->ge, LSB = x->LSB;
    const int64_t Q = x->Q, top = x->top, bottom = x->bottom;
    const int64_t step = x->step, off = x->off, alpha = x->alpha;
    const uint8_t *query = x->query;
    const int32_t *matrix = x->matrix;
    int32_t *hbuf = x->hbuf, *ebuf = x->ebuf;

    int64_t rs = c - top; if (rs < 0) rs = 0;
    int64_t re = c + bottom; if (re > Q - 1) re = Q - 1;
    /* previous column's band (valid for c >= 1). Band borders move by
     * at most one row per column, so rs is always >= prs, and at most
     * the single tail row r == re can fall outside [prs, pre]. */
    int64_t prs = (c - 1) - top; if (prs < 0) prs = 0;
    int64_t pre = (c - 1) + bottom; if (pre > Q - 1) pre = Q - 1;
    int32_t uF, uH, ulH;
    if (rs == 0) {
        uF = LSB;
        uH = (int32_t)(-go - (int64_t)c * ge);
        ulH = (c == 0) ? 0 : uH + ge;
    } else {
        uH = uF = LSB;
        if (c == 0) {
            ulH = (int32_t)(-go - (int64_t)(rs - 1) * ge);
        } else {
            ulH = (rs - 1 >= prs && rs - 1 <= pre) ? hbuf[rs - 1] : LSB;
        }
    }
    unsigned char tc_letter = x->target[c];
    const int32_t *prow =
        x->prof ? x->prof + (int64_t)tc_letter * Q : NULL;
    int32_t colmax = -(int32_t)1073741824; /* NEGINF */
    int32_t h_last = colmax;
    int have_last = 0;
    int64_t base = -c * step + off;  /* within-column offset of row 0 */
    if (c == 0) {
        int32_t *Hc = Hcol + rs + base;
        int32_t *Ec = Ecol + rs + base;
        int32_t *Fc = Fcol + rs + base;
        for (int64_t r = rs; r <= re; r++) {
            int32_t pH = (int32_t)(-go - (int64_t)r * ge);
            int32_t E = max32(pH - go, LSB - ge);
            int32_t F = max32(uH - go, uF - ge);
            int32_t s = prow ? prow[r]
                             : matrix[(int64_t)query[r] * alpha + tc_letter];
            int32_t H = max32(E, max32(F, ulH + s));
            if (H > colmax) colmax = H;
            uF = F; uH = H; ulH = pH;
            *Hc++ = H; *Ec++ = E; *Fc++ = F;
            hbuf[r] = H; ebuf[r] = E;
            h_last = H; have_last = 1;
        }
    } else {
        /* The bulk rows [rs, min(re, pre)] lie inside the previous
         * column's band, so hbuf/ebuf hold its final H/E for them. */
        int64_t bulk_end = re < pre ? re : pre;
        int64_t nb = bulk_end - rs + 1;
        int32_t *restrict Hc = Hcol + rs + base;
        int32_t *restrict Ec = Ecol + rs + base;
        int32_t *restrict Fc = Fcol + rs + base;
        int32_t *restrict hb = hbuf + rs;
        int32_t *restrict eb = ebuf + rs;
        int32_t *restrict ht = x->htmp;
        if (nb > 0) {
            int32_t ulH_tail = hb[nb - 1]; /* pH of last bulk row */
            /* Pass 1 (auto-vectorizes: stride-1 streams, no loop-carried
             * state): E and the F-less H candidate. Gotoh's F[i] needs
             * only the FINAL H[i-1]/F[i-1], so deferring F to a short
             * serial pass is exact for any go/ge — same integers as the
             * fused recurrence. eb is updated in place (read old, write
             * new, same index). */
            {
                int32_t E0 = max32(hb[0] - go, eb[0] - ge);
                int32_t s0 = prow ? prow[rs]
                                  : matrix[(int64_t)query[rs] * alpha
                                           + tc_letter];
                Ec[0] = E0; eb[0] = E0;
                ht[0] = max32(E0, ulH + s0);
            }
            if (prow) {
                const int32_t *restrict pr = prow + rs;
                for (int64_t i = 1; i < nb; i++) {
                    int32_t E = max32(hb[i] - go, eb[i] - ge);
                    Ec[i] = E; eb[i] = E;
                    ht[i] = max32(E, hb[i - 1] + pr[i]);
                }
            } else {
                for (int64_t i = 1; i < nb; i++) {
                    int32_t E = max32(hb[i] - go, eb[i] - ge);
                    int32_t s = matrix[(int64_t)query[rs + i] * alpha
                                       + tc_letter];
                    Ec[i] = E; eb[i] = E;
                    ht[i] = max32(E, hb[i - 1] + s);
                }
            }
            /* Pass 2: F chain, final H, column max. The serial chain
             * binds at ~4 cycles/cell (sub->max->max dependency); for
             * ge <= go it has the exact max-plus prefix form
             *   F[i] = A[i-1] - (go - ge) - i*ge,
             *   A[i] = max(A[i-1], Htmp[i] + i*ge), A[-1] = F0+go-ge
             * (the same identity the pallas kernel's per-column scan
             * uses, engine/pallas_kernels.py) — a PLAIN prefix max,
             * vectorized below in 16-lane AVX-512 blocks via log-step
             * shift-in maxes. Bit-identical to the serial chain. */
            int64_t i0 = 0;
#if defined(__AVX512F__)
            if (ge <= go && nb >= 32) {
                int32_t F0 = max32(uH - go, uF - ge);
                int32_t carry = F0 + go - ge; /* A[-1] */
                const __m512i vgoge = _mm512_set1_epi32(go - ge);
                const __m512i vneg = _mm512_set1_epi32(INT32_MIN);
                const __m512i v15 = _mm512_set1_epi32(15);
                __m512i vcolmax = vneg;
                __m512i vcarry = _mm512_set1_epi32(carry);
                int64_t nv = nb & ~(int64_t)15;
                const int32_t *rampp = x->ramp;
                for (int64_t i = 0; i < nv; i += 16) {
                    __m512i h_v = _mm512_loadu_si512(
                        (const void *)(ht + i));
                    __m512i rp = _mm512_loadu_si512(
                        (const void *)(rampp + i));
                    __m512i X = _mm512_add_epi32(h_v, rp);
                    /* in-register prefix max (shift-in INT32_MIN) */
                    X = _mm512_max_epi32(
                        X, _mm512_alignr_epi32(X, vneg, 15));
                    X = _mm512_max_epi32(
                        X, _mm512_alignr_epi32(X, vneg, 14));
                    X = _mm512_max_epi32(
                        X, _mm512_alignr_epi32(X, vneg, 12));
                    X = _mm512_max_epi32(
                        X, _mm512_alignr_epi32(X, vneg, 8));
                    __m512i A = _mm512_max_epi32(X, vcarry);
                    /* [carry, A0..A14] */
                    __m512i As = _mm512_alignr_epi32(A, vcarry, 15);
                    __m512i F = _mm512_sub_epi32(
                        _mm512_sub_epi32(As, vgoge), rp);
                    __m512i H = _mm512_max_epi32(h_v, F);
                    _mm512_storeu_si512((void *)(Fc + i), F);
                    _mm512_storeu_si512((void *)(Hc + i), H);
                    _mm512_storeu_si512((void *)(hb + i), H);
                    vcolmax = _mm512_max_epi32(vcolmax, H);
                    vcarry = _mm512_permutexvar_epi32(v15, A);
                }
                int32_t vm = _mm512_reduce_max_epi32(vcolmax);
                if (vm > colmax) colmax = vm;
                uF = Fc[nv - 1];
                uH = hb[nv - 1];
                i0 = nv;
            }
#endif
            for (int64_t i = i0; i < nb; i++) {
                int32_t F = max32(uH - go, uF - ge);
                int32_t H = ht[i];
                if (F > H) H = F;
                Fc[i] = F;
                Hc[i] = H; hb[i] = H;
                if (H > colmax) colmax = H;
                uF = F; uH = H;
            }
            ulH = ulH_tail;
            h_last = hb[nb - 1]; have_last = 1;
        }
        if (re > bulk_end) {  /* tail row below the previous band */
            int32_t E = max32(LSB - go, LSB - ge);
            int32_t F = max32(uH - go, uF - ge);
            int32_t s = prow ? prow[re]
                             : matrix[(int64_t)query[re] * alpha
                                      + tc_letter];
            int32_t H = max32(E, max32(F, ulH + s));
            if (H > colmax) colmax = H;
            Hc[nb] = H; Ec[nb] = E; Fc[nb] = F;
            hbuf[re] = H; ebuf[re] = E;
            h_last = H; have_last = 1;
        }
    }
    if (have_last) *H_last = h_last;
    /* column-level tracker merge (exactly the reference's semantics:
     * the early stop tests max_score once per column anyway) */
    if (x->mode == MODE_SW || (x->mode == MODE_OV && c == x->T - 1)) {
        if (colmax > *max_score) *max_score = colmax;
    }
    /* out-of-band rows of this column read as LSB lazily (see hbuf/ebuf
     * band checks). */
    if (x->mode == MODE_HW || x->mode == MODE_OV) {
        if (*H_last > *max_score) *max_score = *H_last;
    }
}

int64_t opal_find_alignment(
    const uint8_t *query, int64_t Q, const uint8_t *target, int64_t T,
    int32_t go, int32_t ge, const int32_t *matrix, int64_t alpha,
    int32_t score_limit, int32_t mode, int64_t bottom, int64_t top,
    int64_t step, int64_t off,               /* storage mapping (see above) */
    int64_t ck,                              /* 0: full store; else block */
    int32_t *Hm, int32_t *Em, int32_t *Fm,   /* [rows*T] full | [rows*ck] */
    int32_t *Hk, int32_t *Ek, int32_t *Fk,   /* [rows*(T/ck)] checkpoints */
    int32_t *out_score, int64_t *out_end_q, int64_t *out_end_t,
    uint8_t *out_ops, int64_t *out_ops_len)
{
    const int32_t INT32_MIN_HALF = -(int32_t)1073741824; /* -2^30 */
    const int32_t LSB = INT32_MIN_HALF + (go > ge ? go : ge);
    const int32_t NEGINF = INT32_MIN_HALF;
    const int64_t rows = step ? (bottom + top + 1) : Q;

    /* column -> storage slot: the ring window wraps in checkpointed mode */
#define COLH(c) (Hm + (ck ? ((c) % ck) : (c)) * rows)
#define COLE(c) (Em + (ck ? ((c) % ck) : (c)) * rows)
#define COLF(c) (Fm + (ck ? ((c) % ck) : (c)) * rows)
    /* within-column offset of absolute row r at column c */
#define ROFF(r, c) ((r) - (c) * step + off)

    /* Per-pair query profile prof[letter*Q + r] = matrix[query[r]*alpha +
     * letter]: turns the per-cell 2D score gather into one sequential
     * stream per column. Gated off when the O(alpha*Q) build would rival
     * the band area (narrow bands over long queries). */
    int32_t *prof = NULL;
    if (alpha * Q * 8 <= rows * T) {
        prof = (int32_t *)malloc(sizeof(int32_t) * (size_t)(alpha * Q));
        if (prof) {
            for (int64_t a = 0; a < alpha; a++) {
                int32_t *pr = prof + a * Q;
                for (int64_t r = 0; r < Q; r++)
                    pr[r] = matrix[(int64_t)query[r] * alpha + a];
            }
        }
    }

    /* Column-carry scratch, indexed by ABSOLUTE query row: hbuf/ebuf hold
     * the previous column's final H/E for rows inside its band (stale
     * elsewhere — every read is band-checked), htmp stages pass 1's F-less
     * H candidates. These stay L1/L2-resident, so the big matrices are
     * written once each and never re-read during the fill: DP-fill DRAM
     * traffic drops from ~28 B/cell (read-back layout) to 12 B/cell of
     * pure streaming stores. */
    int32_t *scratch = (int32_t *)malloc(sizeof(int32_t) * (size_t)(4 * Q));
    if (!scratch) { free(prof); return -3; }
    int32_t *hbuf = scratch, *ebuf = scratch + Q, *htmp = scratch + 2 * Q;
    int32_t *ramp = scratch + 3 * Q;  /* i*ge decay ramp for the F scan */
    for (int64_t r = 0; r < Q; r++) ramp[r] = (int32_t)(r * (int64_t)ge);

    fa_ctx x = {
        query, target, Q, T, go, ge, matrix, alpha, mode,
        bottom, top, step, off, rows, prof, ramp, hbuf, ebuf, htmp, LSB,
    };

    int64_t rc = 0;
    int32_t max_score = NEGINF;
    int32_t H_last = NEGINF;
    int64_t c;
    for (c = 0; c < T && max_score < score_limit; c++) {
        fill_column(&x, c, COLH(c), COLE(c), COLF(c), &max_score, &H_last);
        if (ck && (c + 1) % ck == 0) {
            /* keep column c = m*ck - 1 as checkpoint m-1 (the carry seed
             * for re-deriving block m during the backtrace) */
            int64_t m = (c + 1) / ck - 1;
            memcpy(Hk + m * rows, COLH(c), sizeof(int32_t) * (size_t)rows);
            memcpy(Ek + m * rows, COLE(c), sizeof(int32_t) * (size_t)rows);
            memcpy(Fk + m * rows, COLF(c), sizeof(int32_t) * (size_t)rows);
        }
    }
    int64_t last_col = c - 1;

    int32_t score;
    int64_t end_q, end_t;
    if (mode == MODE_NW) {
        score = H_last; end_t = T - 1; end_q = Q - 1;
    } else if (mode == MODE_HW) {
        score = max_score; end_t = last_col; end_q = Q - 1;
    } else { /* SW, OV */
        score = max_score; end_t = last_col;
        int64_t rs = last_col - top; if (rs < 0) rs = 0;
        int64_t re = last_col + bottom; if (re > Q - 1) re = Q - 1;
        const int32_t *lastH = COLH(last_col);
        end_q = -1;
        for (int64_t r = rs; r <= re; r++) {
            if (lastH[ROFF(r, last_col)] == max_score) { end_q = r; break; }
        }
        if (end_q < 0) { rc = -1; goto done; }
    }

    /* Backtrace; fields: 0=H, 1=E, 2=F. In checkpointed mode the walk's
     * current column is kept inside a block-aligned ck-column window
     * [cur_blk*ck, ...]; crossing below it re-derives the previous block
     * from its checkpoint via the same fill (bit-identical values). The
     * only read outside the current window is lH at column cc-1 when cc
     * is the window's first column — exactly the checkpoint column. */
    {
        int64_t cur_blk = ck ? last_col / ck : 0;
        int64_t r = end_q, cc = end_t, n = 0;
        int field = 0;
        while (r >= 0 && cc >= 0) {
            if (ck && cc < cur_blk * ck) {
                /* entered the previous block: re-derive it */
                cur_blk = cc / ck;
                int64_t b0 = cur_blk * ck;
                if (cur_blk > 0) {
                    /* restore the carry from checkpoint column b0-1 */
                    int64_t cs = b0 - 1;
                    int64_t krs = cs - top; if (krs < 0) krs = 0;
                    int64_t kre = cs + bottom; if (kre > Q - 1) kre = Q - 1;
                    const int32_t *Hs = Hk + (cur_blk - 1) * rows;
                    const int32_t *Es = Ek + (cur_blk - 1) * rows;
                    for (int64_t rr = krs; rr <= kre; rr++) {
                        hbuf[rr] = Hs[ROFF(rr, cs)];
                        ebuf[rr] = Es[ROFF(rr, cs)];
                    }
                }
                int32_t dms = NEGINF, dhl = NEGINF; /* dummy trackers */
                int64_t e = b0 + ck;
                if (e > last_col + 1) e = last_col + 1;
                for (int64_t c2 = b0; c2 < e; c2++)
                    fill_column(&x, c2, COLH(c2), COLE(c2), COLF(c2),
                                &dms, &dhl);
            }
            /* in-band check: out-of-band cells behave as LSB everywhere */
            int64_t rs = cc - top; if (rs < 0) rs = 0;
            int64_t re = cc + bottom; if (re > Q - 1) re = Q - 1;
            int in_band = (r >= rs && r <= re);
            int32_t vH = in_band ? COLH(cc)[ROFF(r, cc)] : LSB;
            int32_t vE = in_band ? COLE(cc)[ROFF(r, cc)] : LSB;
            int32_t vF = in_band ? COLF(cc)[ROFF(r, cc)] : LSB;
            if (field == 0) {
                if (vH == vE) field = 1;
                else if (vH == vF) field = 2;
                else {
                    out_ops[n++] =
                        (query[r] == target[cc]) ? OP_MATCH : OP_MISMATCH;
                    r--; cc--;
                }
            } else if (field == 1) {
                if (cc > 0) {
                    int64_t prs = (cc - 1) - top; if (prs < 0) prs = 0;
                    int64_t pre = (cc - 1) + bottom;
                    if (pre > Q - 1) pre = Q - 1;
                    int32_t lH;
                    if (r < prs || r > pre) {
                        lH = LSB;
                    } else if (ck && cc - 1 < cur_blk * ck) {
                        /* one-column peek across the window edge: cc-1
                         * is checkpoint column cur_blk*ck - 1 */
                        lH = Hk[(cur_blk - 1) * rows + ROFF(r, cc - 1)];
                    } else {
                        lH = COLH(cc - 1)[ROFF(r, cc - 1)];
                    }
                    field = (vE == lH - go) ? 0 : 1;
                }
                out_ops[n++] = OP_INS;
                cc--;
            } else {
                if (r > 0) {
                    int32_t upH = (r - 1 >= rs && r - 1 <= re)
                                      ? COLH(cc)[ROFF(r - 1, cc)] : LSB;
                    field = (vF == upH - go) ? 0 : 2;
                }
                out_ops[n++] = OP_DEL;
                r--;
            }
            if (n > Q + T) { rc = -2; goto done; }
        }
        while (r >= 0) { out_ops[n++] = OP_DEL; r--; }
        while (cc >= 0) { out_ops[n++] = OP_INS; cc--; }

        /* reverse ops in place */
        for (int64_t i = 0; i < n / 2; i++) {
            uint8_t tmp = out_ops[i];
            out_ops[i] = out_ops[n - 1 - i];
            out_ops[n - 1 - i] = tmp;
        }
        *out_score = score;
        *out_end_q = end_q;
        *out_end_t = end_t;
        *out_ops_len = n;
    }
done:
    free(prof);
    free(scratch);
    return rc;
#undef COLH
#undef COLE
#undef COLF
#undef ROFF
}
