"""opal_aligner-compatible command-line interface (opal_tpu's cli.py on the
port: --device in place of --backend).

Same flags, same output format as the reference CLI
(reference: src/opal_aligner.cpp:20-235): ``-a`` mode, ``-o`` gapOpen,
``-e`` gapExt, ``-m`` matrix name, ``-f`` matrix file, ``-s`` silent,
``-x`` search level, positional <query.fasta> <db.fasta>. Output per
sequence: ``#i: score (qstart, tstart) (qend, tend)`` plus optional pretty
alignment blocks, and the CPU-time / GCUPS trailer.

Run as ``python -m opal_tpu_torch.cli [options] query.fasta db.fasta``.
The search runs on the CUDA card unless ``--device cpu`` asks for the
kernels' plain PyTorch versions; without CUDA the default exits with an
error. ``--profile DIR`` writes a torch.profiler trace of each chunk's
search into DIR.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .constants import (
    MODE_CODES,
    OVERFLOW_BUCKETS,
    SEARCH_ALIGNMENT,
    SEARCH_SCORE,
    SEARCH_SCORE_END,
)
from .engine.search import (
    Engine,
    alignment_pass,
    search_database,
    search_database_multi_arrays,
)
from .fasta import open_fasta, read_fasta_sequences
from .matrices import ScoreMatrix
from .ranking import rank_scores
from .render import render_alignment, result_line
from .result import SearchResult


def _run_queries(queries, db, args, score_matrix, mode, engine,
                 search_type=None):
    """Search the DB chunk with every query; returns per-query result lists.
    Score and score+end multi-query batches take the stacked-kernel fast
    path (any mode); full-alignment searches run per query."""
    search_type = args.search_type if search_type is None else search_type
    if len(queries) > 1 and search_type in (SEARCH_SCORE, SEARCH_SCORE_END):
        outs = search_database_multi_arrays(
            queries, db, args.gap_open, args.gap_ext, score_matrix.matrix,
            mode=mode, search_type=search_type, engine=engine,
        )
        per_query = []
        for out in outs:
            rs = []
            if search_type == SEARCH_SCORE:
                for sc in out["score"].tolist():
                    r = SearchResult()
                    r.set_score(sc)
                    rs.append(r)
            else:
                for sc, eq, et in zip(out["score"].tolist(),
                                      out["end_q"].tolist(),
                                      out["end_t"].tolist()):
                    r = SearchResult()
                    r.set_score(sc)
                    r.end_location_query = eq
                    r.end_location_target = et
                    rs.append(r)
            per_query.append(rs)
        return per_query
    return [
        search_database(
            q, db, args.gap_open, args.gap_ext, score_matrix.matrix,
            mode=mode, search_type=search_type,
            overflow_method=OVERFLOW_BUCKETS, engine=engine,
        )
        for q in queries
    ]


def _start_profile(trace_dir, engine):
    """A running torch.profiler over the host and, on the card, the CUDA
    activity; None without trace_dir."""
    if not trace_dir:
        return None
    import torch.profiler as tp

    os.makedirs(trace_dir, exist_ok=True)
    acts = [tp.ProfilerActivity.CPU]
    if engine.device.type == "cuda":
        acts.append(tp.ProfilerActivity.CUDA)
    prof = tp.profile(activities=acts)
    prof.start()
    return prof


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="opal_tpu_torch",
        description="massive optimal sequence alignment on a CUDA card "
        "(opal_aligner-compatible CLI)",
    )
    p.add_argument("-a", dest="mode", default="SW",
                   choices=sorted(MODE_CODES), help="alignment mode")
    p.add_argument("-o", dest="gap_open", type=int, default=3,
                   help="gap opening penalty")
    p.add_argument("-e", dest="gap_ext", type=int, default=1,
                   help="gap extension penalty")
    p.add_argument("-m", dest="matrix_name", default="Blosum50",
                   help="score matrix name (built-ins: blosum45/50/62/80, "
                   "pam120/250)")
    p.add_argument("-f", dest="matrix_file", default=None,
                   help="score matrix file (overrides -m)")
    p.add_argument("-s", dest="silent", action="store_true",
                   help="silent mode: no per-sequence output")
    p.add_argument("-x", dest="search_type", type=int, default=SEARCH_SCORE,
                   choices=[0, 1, 2],
                   help="search level: 0=score, 1=+end location, "
                   "2=+start location and alignment")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda (default) or cpu (the kernels' plain PyTorch "
                   "versions)")
    p.add_argument("--block-size", type=int, default=1024,
                   help="DB sequences per device block")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of each chunk's "
                   "search into DIR (chunk<N>.json, Chrome trace format)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="journal per-chunk results to FILE; re-running with "
                   "the same file resumes after the last completed DB chunk")
    p.add_argument("--chunk-residues", type=int, default=None,
                   metavar="N", help="DB chunk residue budget "
                   "(default ~1 GiB, like the reference)")
    p.add_argument("--align-top", type=int, default=0, metavar="K",
                   help="with -x 2: reconstruct alignment paths only for "
                   "the GLOBAL K best-scoring sequences across the whole "
                   "database (all chunks); other sequences keep exact "
                   "score and end locations. Per-chunk result lines print "
                   "ends only; the ranked top-K alignments print after "
                   "the last chunk. 0 = align all")
    p.add_argument("--all-queries", action="store_true",
                   help="search every sequence in the query file, not just "
                   "the first (score and score+end batches run as stacked "
                   "multi-query kernel launches, any mode)")
    p.add_argument("query")
    p.add_argument("db")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.matrix_file:
        score_matrix = ScoreMatrix.from_file(args.matrix_file)
    else:
        try:
            score_matrix = ScoreMatrix.from_name(args.matrix_name)
        except KeyError:
            print("Given score matrix name is not valid", file=sys.stderr)
            return 1
    mode = MODE_CODES[args.mode]
    if args.search_type == SEARCH_ALIGNMENT and args.gap_ext > args.gap_open:
        print(
            "opal_tpu_torch: error: alignment search (-x 2) requires "
            "gap_ext <= gap_open (scores via -x 0/1 remain available)",
            file=sys.stderr,
        )
        return 1
    lut = score_matrix.letter_index()

    print(f"Using {args.mode} alignment mode.")

    print("Reading query fasta file...")
    with open_fasta(args.query) as f:
        qseqs, _ = read_fasta_sequences(f, lut)
    queries = qseqs if args.all_queries else qseqs[:1]
    query = queries[0]
    if args.all_queries:
        print(f"Read {len(queries)} query sequences, "
              f"{sum(len(q) for q in queries)} residues total.")
    else:
        print(f"Read query sequence, {len(query)} residues.")

    try:
        engine = Engine(device=args.device, block_size=args.block_size)
    except RuntimeError as exc:  # no CUDA for the default device
        print(f"opal_tpu_torch: error: {exc}", file=sys.stderr)
        return 1

    ckpt = None
    if args.checkpoint:
        from .checkpoint import Checkpoint, search_key

        try:
            ckpt = Checkpoint(
                args.checkpoint,
                search_key(queries, mode, args.search_type, args.gap_open,
                           args.gap_ext, score_matrix.matrix, args.db,
                           chunk_residues=args.chunk_residues,
                           align_top_k=args.align_top),
            )
        except ValueError as exc:
            print(f"opal_tpu_torch: error: {exc}", file=sys.stderr)
            return 1

    read_kw = {}
    if args.chunk_residues:
        read_kw["max_residues"] = args.chunk_residues

    # Global --align-top: score+end every chunk first, then align only the
    # global top K. Each chunk's local top K is a superset of the global
    # winners it contributes, so only K sequences per chunk are retained.
    global_align_top = (args.align_top > 0
                        and args.search_type == SEARCH_ALIGNMENT)
    candidates = [[] for _ in queries]  # per query: (global_idx, seq, res)

    cpu_time = 0.0
    db_total_residues = 0
    computed_residues = 0  # residues actually searched (not journal-restored)
    db_total_len = 0
    chunk_idx = 0
    whole_db_read = False
    with open_fasta(args.db) as dbf:
        while not whole_db_read:
            print("\nReading database fasta file...")
            db, whole_db_read = read_fasta_sequences(dbf, lut, **read_kw)
            n_res = sum(len(s) for s in db)
            print(f"Read {len(db)} database sequences, {n_res} residues total.")
            db_total_residues += n_res
            db_total_len += len(db)
            if whole_db_read:
                print(
                    f"Whole database read: {db_total_len} database sequences,"
                    f" {db_total_residues} residues in total."
                )

            print("\nComparing query to database...", end="", flush=True)
            if ckpt is not None and ckpt.has(chunk_idx):
                per_query = ckpt.load(chunk_idx)
                print(f"\nChunk {chunk_idx} restored from checkpoint.")
            else:
                profiler = _start_profile(args.profile, engine)
                start = time.perf_counter()
                per_query = _run_queries(
                    queries, db, args, score_matrix, mode, engine,
                    search_type=(1 if global_align_top
                                 else args.search_type),
                )
                cpu_time += time.perf_counter() - start
                computed_residues += n_res
                if profiler is not None:
                    profiler.stop()
                    profiler.export_chrome_trace(os.path.join(
                        args.profile, f"chunk{chunk_idx}.json"))
                if ckpt is not None:
                    ckpt.save(chunk_idx, per_query)
                print("\nFinished!")
            chunk_idx += 1

            if global_align_top:
                base0 = db_total_len - len(db)
                for k, results in enumerate(per_query):
                    scores = np.array(
                        [r.score if r.score_set else -(2**62)
                         for r in results])
                    for i in rank_scores(scores, args.align_top).tolist():
                        candidates[k].append(
                            (base0 + i, db[i], results[i]))

            if not args.silent:
                base = db_total_len - len(db)
                for k, results in enumerate(per_query):
                    if args.all_queries:
                        print(f"\nQuery #{k}: {len(queries[k])} residues")
                    print(
                        "\n#<i>: <score> (<query start>, <target start>)"
                        " (<query end>, <target end>)"
                    )
                    # batch stdout writes: per-row print() costs more than
                    # the search itself at 541k rows (syscall + flush per
                    # line); join blocks of rows into single writes
                    buf = []
                    for i, (r, t) in enumerate(zip(results, db)):
                        buf.append(result_line(base + i, r))
                        if r.alignment is not None:
                            buf.append(render_alignment(
                                queries[k], t, r, score_matrix.alphabet))
                        if len(buf) >= 50000:
                            sys.stdout.write("\n".join(buf) + "\n")
                            buf = []
                    if buf:
                        sys.stdout.write("\n".join(buf) + "\n")

    if global_align_top:
        start = time.perf_counter()
        sections = []
        for k, cand in enumerate(candidates):
            cand.sort(key=lambda c: (-c[2].score, c[0]))
            winners = cand[: args.align_top]
            # shared sparse alignment pass (threaded across host cores,
            # SW score-0 + degenerate-optimum handling identical to the
            # library/serve paths)
            res_by_gi = {gi: r for gi, _, r in winners}
            seq_by_gi = {gi: t for gi, t, _ in winners}
            alignment_pass(queries[k], seq_by_gi, args.gap_open,
                           args.gap_ext, score_matrix.matrix, mode,
                           res_by_gi, list(res_by_gi), device=engine.device)
            sections.append(winners)
        cpu_time += time.perf_counter() - start
        if not args.silent:
            for k, lines in enumerate(sections):
                hdr = (f"\nGlobal top {len(lines)} alignments"
                       + (f" (query #{k})" if args.all_queries else "")
                       + ":")
                print(hdr)
                for gi, t, r in lines:
                    print(result_line(gi, r))
                    if r.alignment is not None:
                        print(render_alignment(
                            queries[k], t, r, score_matrix.alphabet),
                            end="")
                        print()

    print(f"\nCpu time of searching: {cpu_time:.2f}")
    if args.search_type != SEARCH_ALIGNMENT:
        # GCUPS counts only freshly computed chunks (journal-restored
        # chunks cost no search time and must not inflate throughput)
        q_res = sum(len(q) for q in queries)
        gcups = computed_residues / 1e9 * q_res / cpu_time if cpu_time else 0.0
        print(f"GCUPS (giga cell updates per second): {gcups:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
