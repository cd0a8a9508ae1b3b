"""X-ray atomic form-factor (Cromer-Mann) coefficients.

Copied from ``lammps_analysis_tpu/data/form_factors.py`` (numpy only).
Replaces the reference's bundled CSV (``mdsuite/data/form_fac_coeffs.csv``)
with an in-code table of the standard 4-Gaussian Cromer-Mann
parameterisation ``f(q) = sum_i a_i exp(-b_i (q / 4 pi)^2) + c`` for common
elements (public data, International Tables for Crystallography Vol. C).
Extend ``CROMER_MANN`` for additional species as needed.
"""

from __future__ import annotations

import numpy as np

#: element -> (a1..a4, b1..b4, c)
CROMER_MANN = {
    "H": ([0.489918, 0.262003, 0.196767, 0.049879],
          [20.6593, 7.74039, 49.5519, 2.20159], 0.001305),
    "Li": ([1.1282, 0.7508, 0.6175, 0.4653],
           [3.9546, 1.0524, 85.3905, 168.261], 0.0377),
    "C": ([2.31, 1.02, 1.5886, 0.865],
          [20.8439, 10.2075, 0.5687, 51.6512], 0.2156),
    "N": ([12.2126, 3.1322, 2.0125, 1.1663],
          [0.0057, 9.8933, 28.9975, 0.5826], -11.529),
    "O": ([3.0485, 2.2868, 1.5463, 0.867],
          [13.2771, 5.7011, 0.3239, 32.9089], 0.2508),
    "F": ([3.5392, 2.6412, 1.517, 1.0243],
          [10.2825, 4.2944, 0.2615, 26.1476], 0.2776),
    "Na": ([4.7626, 3.1736, 1.2674, 1.1128],
           [3.285, 8.8422, 0.3136, 129.424], 0.676),
    "Mg": ([5.4204, 2.1735, 1.2269, 2.3073],
           [2.8275, 79.2611, 0.3808, 7.1937], 0.8584),
    "Si": ([6.2915, 3.0353, 1.9891, 1.541],
           [2.4386, 32.3337, 0.6785, 81.6937], 1.1407),
    "P": ([6.4345, 4.1791, 1.78, 1.4908],
          [1.9067, 27.157, 0.526, 68.1645], 1.1149),
    "S": ([6.9053, 5.2034, 1.4379, 1.5863],
          [1.4679, 22.2151, 0.2536, 56.172], 0.8669),
    "Cl": ([11.4604, 7.1964, 6.2556, 1.6455],
           [0.0104, 1.1662, 18.5194, 47.7784], -9.5574),
    "K": ([8.2186, 7.4398, 1.0519, 0.8659],
          [12.7949, 0.7748, 213.187, 41.6841], 1.4228),
    "Ca": ([8.6266, 7.3873, 1.5899, 1.0211],
           [10.4421, 0.6599, 85.7484, 178.437], 1.3751),
    "Fe": ([11.7695, 7.3573, 3.5222, 2.3045],
           [4.7611, 0.3072, 15.3535, 76.8805], 1.0369),
    "Cu": ([13.338, 7.1676, 5.6158, 1.6735],
           [3.5828, 0.247, 11.3966, 64.8126], 1.191),
    "Zn": ([14.0743, 7.0318, 5.1652, 2.41],
           [3.2655, 0.2333, 10.3163, 58.7097], 1.3041),
    "Br": ([17.1789, 5.2358, 5.6377, 3.9851],
           [2.1723, 16.5796, 0.2609, 41.4328], 2.9557),
    "I": ([20.1472, 18.9949, 7.5138, 2.2735],
          [4.347, 0.3814, 27.766, 66.8776], 4.0712),
    "Cs": ([20.3892, 19.1062, 10.662, 1.4953],
           [3.569, 0.3107, 24.3879, 213.904], 3.3352),
}


def form_factor(element: str, q_values: np.ndarray) -> np.ndarray:
    """Atomic form factor f(q) for ``element`` at momentum transfers ``q``.

    Uses the standard Cromer-Mann expression with the (q / 4pi)^2 argument.
    (The reference evaluated ``exp(-b * q / 4pi)`` — linear in q,
    ``structure_factor.py:221-227`` — which does not match the published
    parameterisation; the exponent here is the correct quadratic form.)
    """
    base = element.rstrip("0123456789_")
    try:
        a, b, c = CROMER_MANN[base if base in CROMER_MANN else element]
    except KeyError as err:
        raise KeyError(
            f"No Cromer-Mann coefficients for element {element!r}; add them "
            "to lammps_analysis_tpu_torch.data.form_factors.CROMER_MANN."
        ) from err
    q = np.asarray(q_values, dtype=float)
    s2 = (q / (4 * np.pi)) ** 2
    out = np.full_like(q, float(c))
    for ai, bi in zip(a, b):
        out += ai * np.exp(-bi * s2)
    return out
