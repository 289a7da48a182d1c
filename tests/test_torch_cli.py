"""The port's CLI (opal_tpu_torch.cli, --device cpu) against opal_tpu's
(opal_tpu.cli, --backend xla): the same arguments, and the two stdouts must
be equal except for the values of the timing trailer (Cpu time, GCUPS).
"""
import os
import re

import pytest
import torch

from opal_tpu import cli as jax_cli
from opal_tpu_torch import cli

HERE = os.path.dirname(os.path.abspath(__file__))
QUERY = os.path.join(HERE, "port_data", "O74807.fasta")
DB = os.path.join(HERE, "port_data", "uniprot_sprot15.fasta")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs one process per core; torch's own thread pool on top
    of that oversubscribes the machine many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _untimed(text):
    text = re.sub(r"(Cpu time of searching:) [\d.]+", r"\1 T", text)
    return re.sub(r"(GCUPS \(giga cell updates per second\):) [\d.]+",
                  r"\1 G", text)


def _both(capsys, args):
    """(port stdout, opal_tpu stdout) of the same arguments."""
    outs = []
    for main, dev in ((cli.main, ["--device", "cpu"]),
                      (jax_cli.main, ["--backend", "xla"])):
        assert main(dev + ["--block-size", "16"] + args) == 0
        outs.append(capsys.readouterr().out)
    return outs


@pytest.mark.parametrize("mode,x", [("SW", 0), ("SW", 1), ("SW", 2),
                                    ("NW", 2), ("HW", 1), ("OV", 2)])
def test_search_levels_match_jax(capsys, mode, x):
    mine, theirs = _both(capsys, ["-a", mode, "-x", str(x), QUERY, DB])
    assert _untimed(mine) == _untimed(theirs)
    assert mine.count("\n#") >= 15
    if x == 2:
        assert "T: " in mine and "Q: " in mine


@pytest.mark.parametrize("x", [1, 2])
def test_all_queries_match_jax(capsys, x):
    """Every query of the file: stacked multi_dp groups at x1, one query
    at a time at x2."""
    mine, theirs = _both(capsys, ["--all-queries", "-x", str(x), "-o", "5",
                                  "-e", "2", DB, DB])
    assert _untimed(mine) == _untimed(theirs)
    assert mine.count("Query #") == 15


def test_align_top_over_chunks_matches_jax(capsys):
    """--align-top 3 over a database read in chunks: per-chunk lines with
    ends, then the global top 3 with their alignments."""
    mine, theirs = _both(capsys, ["-x", "2", "--align-top", "3",
                                  "--chunk-residues", "700", QUERY, DB])
    assert _untimed(mine) == _untimed(theirs)
    assert mine.count("Reading database fasta file") > 3
    assert "Global top 3 alignments:" in mine


def test_silent_and_matrix_choice_match_jax(capsys):
    mine, theirs = _both(capsys, ["-s", "-m", "Blosum62", "-a", "OV",
                                  "--chunk-residues", "1000", QUERY, DB])
    assert _untimed(mine) == _untimed(theirs)
    assert "#" not in mine


def test_checkpoint_resume_matches_jax(capsys, tmp_path):
    """A journal cut after its first chunk, as an interrupted run leaves
    it: the rerun restores chunk 0 and searches the rest."""
    journals = [tmp_path / "port.ckpt", tmp_path / "jax.ckpt"]
    args = ["-x", "1", "--chunk-residues", "1200", QUERY, DB]
    full = [None, None]
    for k, (main, dev) in enumerate(((cli.main, ["--device", "cpu"]),
                                     (jax_cli.main, ["--backend", "xla"]))):
        assert main(dev + ["--block-size", "16", "--checkpoint",
                           str(journals[k])] + args) == 0
        full[k] = capsys.readouterr().out
        lines = journals[k].read_text().splitlines(keepends=True)
        assert len(lines) > 2  # the header and one line per chunk
        journals[k].write_text("".join(lines[:2]))
    outs = []
    for k, (main, dev) in enumerate(((cli.main, ["--device", "cpu"]),
                                     (jax_cli.main, ["--backend", "xla"]))):
        assert main(dev + ["--block-size", "16", "--checkpoint",
                           str(journals[k])] + args) == 0
        outs.append(capsys.readouterr().out)
    assert _untimed(outs[0]) == _untimed(outs[1])
    assert "Chunk 0 restored from checkpoint." in outs[0]
    assert "Chunk 1 restored" not in outs[0]
    assert _untimed(full[0]) == _untimed(full[1])
    # the restored run prints the same result lines as the full one
    assert ([ln for ln in outs[0].splitlines() if ln.startswith("#")]
            == [ln for ln in full[0].splitlines() if ln.startswith("#")])


def test_default_device_needs_cuda(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([QUERY, DB]) != 0
    assert "CUDA" in capsys.readouterr().err


def test_gap_ext_above_gap_open_refused_at_x2(capsys):
    assert cli.main(["--device", "cpu", "-x", "2", "-o", "1", "-e", "3",
                     QUERY, DB]) == 1
    assert "gap_ext <= gap_open" in capsys.readouterr().err
