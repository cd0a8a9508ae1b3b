"""``benchmarks/k1_xu_ab.py``'s count of K1's SASS instructions a pair
(``pair_loops``), on a listing of the one-copy instantiation of
``csrc/rdf_histogram.cu`` as ``cuobjdump -sass`` gives it for sm_90a:
its unchecked in-box and folded pair loops (``goldens/k1_pair_loops.sass``).
A loop counts its instructions less the species row's recompute, which a
forward branch skips about once a tile, over its pairs' shared reductions;
the kept path counts whole."""

import importlib.util
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("k1_xu_ab", ROOT / "benchmarks" / "k1_xu_ab.py")
k1_xu_ab = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(k1_xu_ab)

SASS = (ROOT / "tests" / "goldens" / "k1_pair_loops.sass").read_text()


@pytest.mark.parametrize("route, instructions, per_pair, fold_ops", [
    ("in-box", 196, 38.5, 0),
    ("fold", 172, 32.5, 12),
])
def test_pair_loop_counts_the_hot_instructions_a_pair(route, instructions, per_pair, fold_ops):
    """4 pairs a loop (kJ), 42 cold instructions of the row's recompute; the
    fold's 3 FADD and 3 FMNMX a pair take the in-box sequences' 12."""
    [loops] = k1_xu_ab.pair_loops(SASS).values()
    [loop] = [found for found in loops if found["route"] == route]
    assert (loop["instructions"], loop["cold"], loop["pairs"]) == (instructions, 42, 4)
    assert loop["per_pair"] == per_pair
    assert loop["FMNMX"] - 2 * loop["pairs"] == fold_ops  # the root's clamp and the bin's
    assert loop["FRND"] == 0 and loop["MUFU"] == 4
