"""ab_multi.py's parts that run without the card: it imports another
tree's package under another name, beside this one, and stacks the served
cell's groups as the cell's clients send them. The timing itself needs
the card (ab_multi.main refuses without CUDA)."""
import os
import sys

import numpy as np

import ab_multi
from benchmark import cell_serve, common
from opal_tpu_torch.engine import kernels
from opal_tpu_torch.matrices import ScoreMatrix

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_other_tree_imports_under_its_own_name():
    other = ab_multi.other_kernels(ROOT, alias="ab_multi_test_tree")
    assert other.__name__ == "ab_multi_test_tree.engine.kernels"
    assert other is not kernels
    assert os.path.samefile(other.__file__, kernels.__file__)
    # its relative imports resolve inside the alias, not to this package
    assert sys.modules["ab_multi_test_tree.engine.batching"] is not \
        sys.modules["opal_tpu_torch.engine.batching"]
    rng = np.random.default_rng(5)
    matrix = ScoreMatrix.blosum50().matrix
    qps = [matrix[rng.integers(0, 24, size=q)].T for q in (1, 31, 33, 64)]
    mine, qs = kernels.prepare_profile_multi(qps)
    theirs, qs2 = other.prepare_profile_multi(qps)
    assert qs == qs2
    np.testing.assert_array_equal(mine, theirs)


def test_variant_plans_restore_the_resident_estimate():
    before = kernels.RESIDENT_THREADS_PER_SM
    with ab_multi.residents(kernels, 640):
        assert kernels.RESIDENT_THREADS_PER_SM == 640
    with ab_multi.residents(kernels, None):
        assert kernels.RESIDENT_THREADS_PER_SM == before
    assert kernels.RESIDENT_THREADS_PER_SM == before


def test_groups_are_the_cells_rounds():
    """Round r stacks the r-th timed request of each of the 8 clients,
    the queries the cell itself makes from its seed."""
    cell, config = common.load_cell(ab_multi.CELL)
    sm = ScoreMatrix.from_name(config["scoring"]["matrix"])
    db, _ = common.synth_database(2000, 7, sm.letter_index())
    groups = ab_multi.groups_of(3, db, sm, 7, cell)
    tr = cell["traffic"]
    clients, per = tr["clients"], tr["requests_per_client"]
    lengths = cell_serve.query_lengths()
    queries, _ = cell_serve.make_queries(
        7, clients * (1 + per + cell_serve.TRACED_REQUESTS), lengths, db,
        sm.alphabet)
    letters = np.frombuffer(sm.alphabet.encode(), np.uint8)
    assert len(groups) == 3
    for r, group in enumerate(groups):
        assert len(group) == clients
        for c, q in enumerate(group):
            i = clients + c * per + r  # client c's r-th timed request
            assert letters[q].tobytes().decode() == queries[i]
            assert len(q) == lengths[i % len(lengths)]
    # each round stacks 8 different lengths of the cycle
    assert all(len({len(q) for q in g}) == clients for g in groups)
