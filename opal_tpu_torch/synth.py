"""Deterministic synthetic protein database, in FASTA or at benchmark scale.

A copy of tools/make_synth_db.py (numpy only): a Swiss-Prot-like length
distribution (lognormal, median ~290, clipped to [30, 5000]) and natural
amino-acid frequencies, one draw stream per seed. make_db and write_fasta
write the same bytes as that tool (tests/data/synth12071.fasta.gz is
make_db(12071, 12071)); make_db_arrays is the vectorized generator the
bench and the tools hold resident.

    python -m opal_tpu_torch.synth OUT.fasta [n_seqs] [seed]
"""
from __future__ import annotations

import sys

import numpy as np

# Natural amino-acid frequencies (UniProt statistics, order matches the
# 20 standard letters below).
AA = "ALGVESIKRDTPNQFYMHCW"
FREQ = np.array([
    8.25, 9.65, 7.07, 6.86, 6.72, 6.63, 5.91, 5.80, 5.53, 5.46,
    5.35, 4.73, 4.06, 3.93, 3.86, 2.92, 2.41, 2.27, 1.38, 1.10,
])
FREQ = FREQ / FREQ.sum()


def make_db(n_seqs: int = 12071, seed: int = 12071):
    """n_seqs sequences as strings, one rng.choice draw per sequence."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(
        rng.lognormal(mean=5.67, sigma=0.65, size=n_seqs), 30, 5000
    ).astype(int)
    seqs = []
    for L in lengths:
        idx = rng.choice(len(AA), size=int(L), p=FREQ)
        seqs.append("".join(AA[i] for i in idx))
    return seqs


def make_db_arrays(n_seqs: int = 541762, seed: int = 541762):
    """List of uint8 ASCII arrays (map through ScoreMatrix.letter_index()
    for engine input); ~1.93e8 residues at the default n. Same length and
    composition distributions as make_db, but another draw stream."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(
        rng.lognormal(mean=5.67, sigma=0.65, size=n_seqs), 30, 5000
    ).astype(np.int64)
    total = int(lengths.sum())
    aa_codes = np.frombuffer(AA.encode(), dtype=np.uint8)
    cum = np.cumsum(FREQ)
    residues = aa_codes[np.searchsorted(cum, rng.random(total))]
    bounds = np.cumsum(lengths)[:-1]
    return np.split(residues, bounds)


def write_fasta(path: str, seqs):
    """`>synth|{i:06d} synthetic sequence len={L}` headers, 60 residues a
    line."""
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">synth|{i:06d} synthetic sequence len={len(s)}\n")
            for j in range(0, len(s), 60):
                f.write(s[j : j + 60] + "\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    out = argv[0] if len(argv) > 0 else "synth12071.fasta"
    n = int(argv[1]) if len(argv) > 1 else 12071
    seed = int(argv[2]) if len(argv) > 2 else 12071
    seqs = make_db(n, seed)
    write_fasta(out, seqs)
    print(f"{out}: {len(seqs)} sequences, {sum(map(len, seqs))} residues")
    return 0


if __name__ == "__main__":
    sys.exit(main())
