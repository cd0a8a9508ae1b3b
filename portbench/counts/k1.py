"""Frozen work count of K1, the RDF's pair-distance histogram
(``csrc/rdf_histogram.cu``), for one call.

The function's work: every unordered pair of atoms of every sampled frame is
tested (at a cutoff of about half the box no cell list can skip a pair),
about 22 float32 operations a pair (3 differences, 3 minimum images of 4,
the sum of squares, the compare) and 2 more a kept pair (the square root and
the bin); the frames read once (12 bytes an atom, 4 for its species) and
the int64 histogram written once.
"""

from portbench.peaks import bound_ms


def bound(work: dict) -> tuple[float, str]:
    """``(least ms a call, set by)`` from the reference's ``work``."""
    n, f = work["n_atoms"], work["frames"]
    pairs = f * n * (n - 1) / 2
    flops = 22 * pairs + 2 * work["kept"]
    n_pairs = work["n_species"] * (work["n_species"] + 1) // 2
    n_bytes = f * n * 12 + n * 4 + n_pairs * work["n_bins"] * 8
    return bound_ms(flops, n_bytes)
