"""Frozen work count of K3, the ADF's pair-angle histogram
(``csrc/adf_pairs_histogram.cu``), for one call.

The function's work on the neighbor lists the frames need: the pairs whose
angle it bins (both neighbors of a species at least the center's), about 30
float32 operations each (the dot product, the division, acos, the bin and
the weight), and a species test for every other listed pair; each list slot
(20 bytes), count and species read once, each frame's histogram written
once.
"""

from portbench.peaks import bound_ms


def bound(work: dict) -> tuple[float, str]:
    """``(least ms a call, set by)`` from the reference's ``work``."""
    f, n = len(work["frames"]), work["n_atoms"]
    n_triples = work["n_species"] * (work["n_species"] + 1) * (work["n_species"] + 2) // 6
    tests = work["listed_pairs"] - work["angles"]
    flops = 30 * work["angles"] + 2 * tests
    n_bytes = work["kept"] * 20 + f * n * 4 + n * 4 + f * n_triples * work["n_bins"] * 4
    return bound_ms(flops, n_bytes)
