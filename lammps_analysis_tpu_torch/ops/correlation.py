"""FFT-based windowed autocorrelation and cross-correlation.

Counterpart of ``windowed_acf_sum``, ``cross_correlation_biased`` and
``window_starts`` in ``lammps_analysis_tpu/ops/correlation.py`` in torch ops
on the tensor's device (``torch.fft``). The reference computes windowed autocorrelations with
``tfp.stats.auto_correlation(..., center=False, normalize=False)`` per sliding
window; ``acf = irfft(|rfft(x, 2T)|^2)[:T] / T`` is the same biased estimator
(denominator ``T`` for every lag), batched over windows, particles and
components.

Precision: the forward FFTs run in the data's dtype (float32 from the store);
the power spectra are summed over particles and components in float64 and
inverted once per window in float64.
"""

from __future__ import annotations

import torch


def _next_fast_len(n: int) -> int:
    """Next power of two >= n."""
    return 1 << (int(n - 1).bit_length())


def window_starts(total: int, window: int, stride: int) -> torch.Tensor:
    """Start indices (int64) of the sliding ensemble windows.

    Windows of length ``window`` every ``stride`` frames; the last window
    must fit entirely (the reference's ensemble loop,
    ``data_manager.py:288-341``).
    """
    n = (total - window) // stride + 1 if total >= window else 0
    return torch.arange(max(n, 0), dtype=torch.int64) * stride


def cross_correlation_biased(x: torch.Tensor, y: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Biased cross-correlation ``(1/T) sum_t x[t] y[t+m]`` along ``dim``.

    The FFT runs in the inputs' dtype; the leading dimensions are a batch
    (many windows correlate in one call). Used by the distinct
    diffusion-coefficient calculators (reference helper ``correlate``,
    ``utils/calculator_helper_methods.py:110-150``).
    """
    x = x.movedim(dim, -1)
    y = y.movedim(dim, -1)
    n = x.shape[-1]
    fft_len = _next_fast_len(2 * n)
    fx = torch.fft.rfft(x, n=fft_len, dim=-1)
    fy = torch.fft.rfft(y, n=fft_len, dim=-1)
    ccf = torch.fft.irfft(torch.conj(fx) * fy, n=fft_len, dim=-1)[..., :n] / n
    return ccf.movedim(-1, dim)


#: a batch may hold more than 32 windows while it stays under this size
BATCH_BYTES = 1 << 28


def _auto_chunk(n: int, d: int, window: int, budget_bytes: int) -> int:
    """Windows per FFT batch that keep its working set in ``budget_bytes``.

    A window's working set is the zero-padded batch plus its complex
    spectrum and power: about ``N * D * fft_len * 16`` bytes. A batch holds
    32 windows (the JAX package's step), or more while it stays under
    ``BATCH_BYTES``: each batch is the same short sequence of launches
    whatever its size, so a one-particle system series (a 10^6-row flux
    log) runs in tens of batches instead of tens of thousands; per-atom
    series keep 32. Never more than the budget holds, never fewer than 1.
    """
    fft_len = _next_fast_len(2 * window)
    per_window = max(n * d * fft_len * 16, 1)
    return max(1, min(int(budget_bytes) // per_window, max(32, BATCH_BYTES // per_window)))


def windowed_acf_sum(
    x: torch.Tensor, window: int, stride: int, budget_bytes: int, tau=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sum of per-window biased ACFs plus the per-window particle-mean ACFs.

    Parameters
    ----------
    x : (T, N, D) time series (frames, particles, components).
    window, stride : ensemble window length and correlation_time stride.
    budget_bytes : memory the FFT batches may take: the experiment planner's
        budget, which sizes the chunk of windows per batch (``_auto_chunk``).
    tau : optional (R,) lag indices: each window is gathered at these
        indices BEFORE the ACF (reference semantics,
        ``green_kubo_ionic_conductivity.py:201``).

    Returns
    -------
    acf_sum : (R,) float64: sum over windows and particles, summed over D,
        of the per-window biased ACF; ``R = window`` when ``tau`` is None.
    per_window : (n_windows, R) float64: per-window particle-MEAN ACF
        summed over D, for the SEM of the running integral
        (``green_kubo_self_diffusion_coefficients.py:199-206``).
    """
    total, n_particles, n_dims = x.shape
    r = window if tau is None else len(tau)
    n_windows = (total - window) // stride + 1 if total >= window else 0
    if n_windows <= 0:
        return (
            torch.zeros(r, dtype=torch.float64, device=x.device),
            torch.zeros((0, r), dtype=torch.float64, device=x.device),
        )
    chunk = _auto_chunk(n_particles, n_dims, r, budget_bytes)
    fft_len = _next_fast_len(2 * r)
    windows = x.unfold(0, window, stride)  # (n_windows, N, D, window): a view
    tau_idx = (
        None if tau is None
        else torch.as_tensor(tau, dtype=torch.long, device=x.device)
    )
    acf_sum = torch.zeros(r, dtype=torch.float64, device=x.device)
    per_window = []
    for c0 in range(0, n_windows, chunk):
        seg = windows[c0 : c0 + chunk]
        if tau_idx is not None:
            seg = seg.index_select(-1, tau_idx)
        # irfft is linear: sum the power spectra over particles and
        # components FIRST and invert once per window
        f = torch.view_as_real(torch.fft.rfft(seg, n=fft_len, dim=-1))
        power = torch.sum(f.square_(), dim=(1, 2, 4), dtype=torch.float64)
        acf = torch.fft.irfft(power, n=fft_len, dim=-1)[:, :r] / r  # sum over N, D
        acf_sum += acf.sum(0)
        per_window.append(acf / n_particles)
    return acf_sum, torch.cat(per_window)
