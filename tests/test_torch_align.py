"""Full alignment (search type 2) of the port on the CPU.

x2 through search_database against opal_tpu's xla engine, field by field
and path by path (4 modes, align_top_k 0 and 3, several gap pairs, SW
score-0 sequences and a length-0 target); the port's native traceback
against its pure-Python path; and the reference binary's x2 goldens, byte
for byte: result lines and alignment blocks.
"""
import gzip
import os
import re

import numpy as np
import pytest
import torch

from opal_tpu.engine.search import Engine as JaxEngine
from opal_tpu.engine.search import search_database as jax_search_database
from opal_tpu.matrices import ScoreMatrix as JaxScoreMatrix
from opal_tpu_torch import _native
from opal_tpu_torch.constants import (
    MODE_CODES,
    MODE_HW,
    MODE_NW,
    MODE_OV,
    MODE_SW,
    SEARCH_ALIGNMENT,
)
from opal_tpu_torch.engine.search import Engine, search_database
from opal_tpu_torch.fasta import read_fasta_file
from opal_tpu_torch.matrices import ScoreMatrix
from opal_tpu_torch.render import render_alignment, result_line
from opal_tpu_torch.traceback import align_pair_reverse_trick, find_alignment

HERE = os.path.dirname(os.path.abspath(__file__))
PORT_DATA = os.path.join(HERE, "port_data")
MODES = [MODE_SW, MODE_NW, MODE_HW, MODE_OV]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """BLOSUM50, a 37-residue query and 40 sequences of 1..90 letters, two
    of them of letters that score <= 0 against the whole query (SW score
    0) and one empty."""
    rng = np.random.default_rng(4321)
    matrix = JaxScoreMatrix.blosum50().matrix
    query = rng.integers(0, 20, size=37).astype(np.uint8)
    db = [rng.integers(0, 20, size=int(L)).astype(np.uint8)
          for L in rng.integers(1, 91, size=40)]
    hostile = [a for a in range(20)
               if all(matrix[q, a] <= 0 for q in query)]
    if not hostile:  # a letter that scores <= 0 against every residue
        hostile = [int(np.argmin(matrix[query].max(axis=0)))]
    db[6] = np.full(12, hostile[0], np.uint8)
    db[21] = np.full(3, hostile[-1], np.uint8)
    db[30] = np.zeros(0, np.uint8)
    return query, db, matrix


def _fields(r):
    ops = None if r.alignment is None else np.asarray(r.alignment).tolist()
    return (r.score_set, r.score, r.end_location_query,
            r.end_location_target, r.start_location_query,
            r.start_location_target, r.alignment_length, ops)


@pytest.mark.filterwarnings("ignore:sequence 30")
@pytest.mark.parametrize("top_k", [0, 3])
@pytest.mark.parametrize("go,ge", [(3, 1), (2, 2), (0, 0)])
@pytest.mark.parametrize("mode", MODES)
def test_x2_matches_jax(problem, mode, go, ge, top_k):
    query, db, matrix = problem
    got = search_database(query, db, go, ge, matrix, mode=mode,
                          search_type=SEARCH_ALIGNMENT, align_top_k=top_k,
                          engine=Engine(device="cpu", block_size=16))
    want = jax_search_database(query, db, go, ge, matrix, mode=mode,
                               search_type=SEARCH_ALIGNMENT,
                               align_top_k=top_k,
                               engine=JaxEngine(backend="xla",
                                                block_size=16))
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    n_paths = sum(r.alignment is not None for r in got)
    assert n_paths >= (3 if top_k else 30)
    if mode == MODE_SW:
        assert got[6].score == 0 and got[6].alignment is None


def test_x2_refuses_gap_ext_above_gap_open(problem):
    query, db, matrix = problem
    with pytest.raises(ValueError, match="gap_ext <= gap_open"):
        search_database(query, db, 1, 3, matrix,
                        search_type=SEARCH_ALIGNMENT,
                        engine=Engine(device="cpu"))


def test_native_traceback_matches_python(problem):
    """The C traceback and the pure-Python one give the same paths, on
    banded, full-band and the ge > go scalar cases."""
    assert _native.available()
    query, db, matrix = problem
    rng = np.random.default_rng(5)
    n = 0
    for t in db[:25]:
        if len(t) == 0:
            continue
        for mode in MODES:
            for go, ge in ((3, 1), (1, 1), (2, 3)):
                for full in (False, True):
                    limit = int(rng.integers(0, 60))
                    outs = []
                    for native in (True, False):
                        try:
                            outs.append(find_alignment(
                                query, t, go, ge, matrix, limit, mode,
                                full_band=full, use_native=native))
                        except Exception as exc:  # noqa: BLE001
                            outs.append(type(exc).__name__)
                    a, b = outs
                    if isinstance(a, tuple) and isinstance(b, tuple):
                        assert a[:3] == b[:3]
                        np.testing.assert_array_equal(a[3], b[3])
                        n += 1
                    else:
                        assert a == b
    assert n > 300
    # and through the reverse trick with replay validation
    res = search_database(query, db[:10], 3, 1, matrix, mode=MODE_OV,
                          search_type=1, engine=Engine(device="cpu"))
    for r, t in zip(res, db[:10]):
        if r.score <= 0:  # pure-gap optima have no anchored path
            continue
        sq, st, ops = align_pair_reverse_trick(
            query, t, 3, 1, matrix, r.score, r.end_location_query,
            r.end_location_target, MODE_OV)
        assert len(ops) and sq >= 0 and st >= 0


def _render(query, db, res, alphabet):
    """The CLI's text from the first result line on: result lines, each
    followed by its alignment blocks."""
    lines = []
    for i, (r, t) in enumerate(zip(res, db)):
        lines.append(result_line(i, r))
        if r.alignment is not None:
            lines.append(render_alignment(query, t, r, alphabet))
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def blosum50():
    return ScoreMatrix.blosum50()


@pytest.fixture(scope="module")
def o74807(blosum50):
    qs, _ = read_fasta_file(os.path.join(PORT_DATA, "O74807.fasta"),
                            blosum50.letter_index())
    return qs[0]


@pytest.mark.parametrize("mode_name", ["SW", "NW", "HW", "OV"])
def test_sprot15_x2_goldens(mode_name, blosum50, o74807):
    db, _ = read_fasta_file(os.path.join(PORT_DATA, "uniprot_sprot15.fasta"),
                            blosum50.letter_index())
    res = search_database(o74807, db, 3, 1, blosum50.matrix,
                          mode=MODE_CODES[mode_name],
                          search_type=SEARCH_ALIGNMENT,
                          engine=Engine(device="cpu", block_size=16))
    path = os.path.join(HERE, "golden",
                        f"O74807__uniprot_sprot15__{mode_name}_x2_o3_e1.txt")
    with open(path) as f:
        want = f.read()
    assert _render(o74807, db, res, blosum50.alphabet) == want


@pytest.mark.parametrize("mode_name", ["SW", "OV"])
def test_synth12071_x2_golden_prefix(mode_name, blosum50, o74807):
    """Results are per sequence, so the first 200 sequences of the
    database reproduce the golden's first 200 records, byte for byte."""
    n = 200
    db, _ = read_fasta_file(os.path.join(HERE, "data", "synth12071.fasta.gz"),
                            blosum50.letter_index())
    db = db[:n]
    res = search_database(o74807, db, 3, 1, blosum50.matrix,
                          mode=MODE_CODES[mode_name],
                          search_type=SEARCH_ALIGNMENT,
                          engine=Engine(device="cpu", block_size=64))
    path = os.path.join(HERE, "golden_large",
                        f"O74807__synth12071__{mode_name}_x2_o3_e1.txt.gz")
    with gzip.open(path, "rt") as f:
        text = f.read()
    want = text[: re.search(rf"^#{n}: ", text, re.M).start()]
    assert _render(o74807, db, res, blosum50.alphabet) == want
