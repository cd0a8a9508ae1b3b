"""Windowed mean-squared-displacement sums.

Counterpart of ``lammps_analysis_tpu/ops/msd.py`` (``_comb_sq_sums`` and
``windowed_msd_sum``) in torch ops on the tensor's device. The JAX package
used only XLA ops here, so torch ops are the port.

The windowed ensemble sum uses the **strided-comb decomposition**: with
origins every ``stride = s`` frames and lags ``tau = j*s + o`` (``o < s``),
the whole ``o``-row for one ``j``

    msd_row_j[o] = sum_{k,n,d} (x(k*s + j*s + o) - x(k*s))^2

is one broadcast-subtract-square-reduce between the origin comb
``x[0 : K*s : s]`` and the contiguous reshape ``x[j*s : j*s + K*s] -> (K, s,
N, D)``: no gathers, and the difference is taken before squaring, so large
terms do not cancel. It takes ``ceil(window / stride)`` passes over the
data; at ``stride = 1`` that is one short chain of launches per lag.

Precision: float32 differences and squares (the store's dtype), summed in
float64.
"""

from __future__ import annotations

import torch


def _comb_sq_sums(x: torch.Tensor, window: int, stride: int) -> tuple[torch.Tensor, int]:
    """Comb-decomposed ``(msd_sums (window,) float64, n_windows)`` for one series.

    ``x`` is ``(T, N, D)``; origins are every ``stride`` frames, windows
    must fit entirely (``K = (T - window)//stride + 1`` of them).
    """
    total = x.shape[0]
    k_windows = (total - window) // stride + 1 if total >= window else 0
    if k_windows <= 0:
        return torch.zeros(window, dtype=torch.float64, device=x.device), 0

    m_blocks = -(-window // stride)  # ceil
    needed = (m_blocks - 1) * stride + k_windows * stride
    pad = max(0, needed - total)
    # padded frames only ever meet lags >= window, which are cut off below
    xp = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) if pad else x

    origins = xp[: k_windows * stride : stride]  # (K, N, D)
    rows = []
    for j in range(m_blocks):
        lo = j * stride
        slab = xp[lo : lo + k_windows * stride].reshape(k_windows, stride, *x.shape[1:])
        diff = (slab - origins[:, None]).square_()
        rows.append(torch.sum(diff, dim=(0, 2, 3), dtype=torch.float64))  # (stride,)
    return torch.cat(rows)[:window], k_windows


def windowed_msd_sum(
    x: torch.Tensor,
    tau_values,
    window: int,
    stride: int,
) -> tuple[torch.Tensor, int]:
    """Sum over windows/particles/components of ``(x(t0 + tau) - x(t0))^2``.

    Parameters
    ----------
    x : (T, N, D) unwrapped positions (or a dipole moment with N = 1).
    tau_values : (R,) lag indices inside each window.
    window : ensemble window length (``data_range``).
    stride : ``correlation_time``.

    Returns
    -------
    msd_sum : (R,) float64 on ``x``'s device: summed (not averaged) squared
        displacements; the caller applies the reference's normalisation.
    n_windows : number of windows accumulated.
    """
    full, k_windows = _comb_sq_sums(x, window, stride)
    tau = torch.as_tensor(tau_values, dtype=torch.long, device=x.device)
    if k_windows == 0:
        return torch.zeros(tau.shape, dtype=torch.float64, device=x.device), 0
    return full[tau], k_windows
