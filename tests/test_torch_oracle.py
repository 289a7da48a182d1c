"""The port's scalar oracle (opal_tpu_torch.oracle) against opal_tpu's, and
the soak tool (python -m opal_tpu_torch.tools.soak) on the CPU.

The oracle is a numpy copy: on the same random problems both oracles must
give the same full H matrices and the same results, field by field. The
soak's plain-version run holds the CPU path against the oracle; on the
card the same tool holds the CUDA kernels against it (chip_smoke.py).
"""
import json

import numpy as np
import pytest

from opal_tpu import oracle as jax_oracle
from opal_tpu_torch import oracle
from opal_tpu_torch.tools import soak

MODES = [0, 1, 2, 3]


def _problem(seed, ge_over_go=False):
    rng = np.random.default_rng(seed)
    A = int(rng.integers(2, 20))
    matrix = rng.integers(-6, 9, size=(A, A)).astype(np.int32)
    go, ge = (1, 3) if ge_over_go else (int(rng.integers(0, 9)), 0)
    if not ge_over_go:
        ge = int(rng.integers(0, go + 1))
    query = rng.integers(0, A, size=int(rng.integers(1, 40)), dtype=np.uint8)
    db = [rng.integers(0, A, size=int(L), dtype=np.uint8)
          for L in rng.integers(1, 50, size=12)]
    return query, db, go, ge, matrix


@pytest.mark.parametrize("slow", [False, True])
@pytest.mark.parametrize("x", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_oracle_matches_jax_oracle(mode, x, slow):
    for seed in range(3):
        query, db, go, ge, matrix = _problem(10 * mode + seed, seed == 2)
        got = oracle.search_oracle(query, db, go, ge, matrix, mode, x, slow)
        want = jax_oracle.search_oracle(query, db, go, ge, matrix, mode, x,
                                        slow)
        assert [(r.score, r.end_location_query, r.end_location_target)
                for r in got] == [(r.score, r.end_location_query,
                                   r.end_location_target) for r in want]
        for t in db[:3]:
            np.testing.assert_array_equal(
                oracle.dp_matrix(query, t, go, ge, matrix, mode),
                jax_oracle.dp_matrix(query, t, go, ge, matrix, mode))


def test_oracle_matches_jax_oracle_past_2_30():
    """Entries near the port's derived int32 bound: the int64 oracles
    agree where the scores pass 2^30."""
    rng = np.random.default_rng(5)
    M = (2**31 - 1) // 110 - 2
    matrix = rng.integers(-M, M + 1, size=(6, 6)).astype(np.int32)
    np.fill_diagonal(matrix, M)
    query = rng.integers(0, 6, size=110, dtype=np.uint8)
    db = [query] + [rng.integers(0, 6, size=int(L), dtype=np.uint8)
                    for L in (1, 64, 200)]
    for mode in MODES:
        got = oracle.search_oracle(query, db, 3, 1, matrix, mode, 1)
        want = jax_oracle.search_oracle(query, db, 3, 1, matrix, mode, 1)
        assert [r.score for r in got] == [r.score for r in want]
        assert got[0].score > 2**30


def test_soak_on_cpu_finds_no_failure(capsys):
    """The soak's trials through the plain versions: 0 failures, both
    kinds of trial, one JSON line."""
    assert soak.main(["--device", "cpu", "--trials", "12", "--seed",
                      "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["failures"] == 0 and out["trials"] == 12
    assert out["kinds"]["single"] > 0 and out["kinds"]["multi"] > 0
    assert sum(out["launches"].values()) == 0


def test_soak_reports_a_failure(monkeypatch):
    """A wrong answer is counted, with the trial's seed and problem."""
    real = soak.search_oracle

    def off_by_one(*a, **k):
        res = real(*a, **k)
        res[0].set_score(res[0].score + 1)
        return res

    monkeypatch.setattr(soak, "search_oracle", off_by_one)
    out = soak.run(trials=2, seed=4, device="cpu")
    assert out["failures"] == 2
    assert "score" in out["first_failure"]["failure"]
    assert out["first_failure"]["seed"] > 0
