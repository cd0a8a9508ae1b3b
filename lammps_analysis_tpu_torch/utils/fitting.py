"""Host-side fitting helpers for Einstein-type calculators.

Copied from ``lammps_analysis_tpu/utils/fitting.py`` (numpy and scipy only).
Port of the *behavior* of ``mdsuite/utils/calculator_helper_methods.py:41-107``
(``fit_einstein_curve``): pick the fit onset where the MSD curve becomes
linear (vanishing second derivative of a quartic spline), then produce an
incremental series of linear fits whose final member is the reported
gradient. Stays on host (scipy) by design — this is cheap post-processing.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.interpolate import UnivariateSpline
from scipy.optimize import curve_fit


def _line(x, m, a):
    return m * x + a


def fit_einstein_curve(
    x_data: np.ndarray, y_data: np.ndarray, fit_max_index: int
) -> Tuple[np.ndarray, np.ndarray, list, list]:
    """Fit a line to the diffusive regime of an MSD curve.

    Returns ``(popt, pcov, gradients, gradient_errors)`` with identical
    semantics to the reference helper: the onset index is where the
    quartic-spline second derivative is smallest (values below 1e-5 snapped
    to zero), gradients accumulate fits over growing windows, and the fit at
    ``fit_max_index`` is the reported one.
    """
    x_data = np.asarray(x_data, dtype=float)
    y_data = np.asarray(y_data, dtype=float)

    spline = UnivariateSpline(x_data, y_data, s=0, k=4)
    second_deriv = spline.derivative(n=2)(x_data)
    second_deriv[np.abs(second_deriv) < 1e-5] = 0
    start_index = int(np.argmin(np.abs(second_deriv)))

    # A linear least-squares fit has a closed form, so ALL incremental fits
    # over growing windows come from prefix sums in O(n) total — identical
    # numbers to the reference's per-window scipy curve_fit loop, without
    # its O(n^2) cost (which dominated large data_range runs).
    slopes, slope_errs, intercepts = _incremental_line_fits(
        x_data[start_index:], y_data[start_index:]
    )
    # window [start_index:i) for i in start_index+2 .. len-1  <-> 2 <= m < n
    n = len(y_data) - start_index
    gradients = list(slopes[2:n])
    gradient_errors = list(slope_errs[2:n])

    popt: np.ndarray = np.array([0.0, 0.0])
    pcov: np.ndarray = np.full((2, 2), np.inf)
    m_sel = fit_max_index - start_index
    if 2 <= m_sel < n:
        popt = np.array([slopes[m_sel], intercepts[m_sel]])
        pcov = np.diag([slope_errs[m_sel] ** 2, np.inf])
    if not gradients:  # degenerate short series: single fit over everything
        popt, pcov = curve_fit(_line, xdata=x_data, ydata=y_data)
        gradients.append(popt[0])
        gradient_errors.append(np.sqrt(np.diag(pcov))[0])
    return popt, pcov, gradients, gradient_errors


def _incremental_line_fits(x: np.ndarray, y: np.ndarray):
    """Least-squares line fits over every prefix ``x[:m]``, ``m = 0..n``.

    Returns ``(slopes, slope_errors, intercepts)`` arrays indexed by prefix
    length ``m`` (entries for m < 2 are NaN). Slope error follows
    ``curve_fit``'s estimate: ``sqrt(sigma^2 * (X^T X)^-1 [0, 0])`` with
    ``sigma^2 = SSR / (m - 2)`` (inf when m == 2).
    """
    n = len(x)
    sx = np.concatenate([[0.0], np.cumsum(x)])
    sy = np.concatenate([[0.0], np.cumsum(y)])
    sxx = np.concatenate([[0.0], np.cumsum(x * x)])
    sxy = np.concatenate([[0.0], np.cumsum(x * y)])
    syy = np.concatenate([[0.0], np.cumsum(y * y)])
    m = np.arange(n + 1, dtype=float)

    with np.errstate(divide="ignore", invalid="ignore"):
        det = m * sxx - sx * sx
        slope = (m * sxy - sx * sy) / det
        intercept = (sxx * sy - sx * sxy) / det
        # residual sum of squares via sufficient statistics
        ssr = (
            syy
            - 2 * slope * sxy
            - 2 * intercept * sy
            + slope**2 * sxx
            + 2 * slope * intercept * sx
            + intercept**2 * m
        )
        dof = m - 2
        sigma2 = np.where(dof > 0, ssr / np.maximum(dof, 1), np.inf)
        slope_var = sigma2 * m / det
        slope_err = np.sqrt(np.maximum(slope_var, 0.0))
        slope_err = np.where(dof > 0, slope_err, np.inf)
    slope[:2] = np.nan
    intercept[:2] = np.nan
    return slope, slope_err, intercept
