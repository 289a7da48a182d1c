/* Native FASTA tokenizer for opal_tpu_torch (a copy of
 * opal_tpu/_native/fasta_parse.c).
 *
 * Single pass over an in-memory buffer: skips '>' header lines, maps residue
 * bytes through a 128-entry alphabet-index LUT (255 = invalid), concatenates
 * residues into out_res and records per-sequence (start, length) spans.
 * Equivalent semantics to the reference CLI's reader
 * (reference: src/opal_aligner.cpp:240-301): '\r'/'\n' contribute nothing,
 * a sequence is opened lazily at its first residue byte, empty records
 * produce no sequence, text before any header is a sequence.
 *
 * Returns the number of sequences, or -(1+pos) if buf[pos] is an invalid
 * residue byte. Caller guarantees out_res has >= n bytes and
 * out_starts/out_lens have one slot per '>' plus one.
 */
#include <stdint.h>

int64_t opal_fasta_parse(
    const unsigned char *buf, int64_t n, const unsigned char *lut,
    unsigned char *out_res, int64_t *out_starts, int64_t *out_lens)
{
    int64_t w = 0;        /* residues written */
    int64_t nseq = 0;
    int64_t cur_start = 0;
    int in_header = 0;
    int in_sequence = 0;

    for (int64_t i = 0; i < n; i++) {
        unsigned char c = buf[i];
        if (in_header) {
            if (c == '\n') in_header = 0;
            continue;
        }
        if (c == '>') {
            if (in_sequence) {
                out_starts[nseq] = cur_start;
                out_lens[nseq] = w - cur_start;
                nseq++;
                in_sequence = 0;
            }
            in_header = 1;
            continue;
        }
        if (c == '\n' || c == '\r') continue;
        if (c > 127) return -(1 + i);
        unsigned char idx = lut[c];
        if (idx == 255) return -(1 + i);
        if (!in_sequence) {
            in_sequence = 1;
            cur_start = w;
        }
        out_res[w++] = idx;
    }
    if (in_sequence) {
        out_starts[nseq] = cur_start;
        out_lens[nseq] = w - cur_start;
        nseq++;
    }
    return nseq;
}
