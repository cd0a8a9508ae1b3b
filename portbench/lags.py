"""Windowed lag sums by direct products, for the Green-Kubo references.

For a series ``x`` ``(T, K)`` (``K`` sequences side by side: ions times
axes, or the three axes of a current), the products of every pair of
frames summed over the sequences form the Gram matrix ``G = x x^T``
``(T, T)``. A window of ``window`` frames starting at ``s`` has as its Gram
matrix the block ``G[s:s+window, s:s+window]``, and its lag sums ``S_s[m] =
sum_{t=s}^{s+window-1-m} G[t, t+m]`` are the sums of that block's
superdiagonals. They come from running sums in float64 along ``G``'s
superdiagonals: no FFT, nothing of the program. The products run in
``dtype`` (float64 for the reference; the control passes bfloat16, whose
matrix product accumulates in float32 and rounds each entry to bfloat16).
"""

from __future__ import annotations

import torch


def windowed_lag_sums(x: torch.Tensor, window: int, stride: int,
                      dtype: torch.dtype) -> torch.Tensor:
    """``(n_windows, window)`` float64: ``S_s[m]`` for the windows starting
    at ``0, stride, 2 stride, ...`` while they fit."""
    x = x.to(dtype)
    t = x.shape[0]
    n_windows = (t - window) // stride + 1 if t >= window else 0
    gram = (x @ x.T).to(torch.float64)
    # row t of the padded matrix read from column t: diag[t, m] = G[t, t + m], 0 past the end
    padded = torch.nn.functional.pad(gram, (0, window))
    diag = padded.as_strided((t, window), (t + window + 1, 1))
    running = torch.zeros((t + 1, window), dtype=torch.float64, device=x.device)
    torch.cumsum(diag, dim=0, out=running[1:])
    starts = torch.arange(n_windows, device=x.device)[:, None] * stride
    lags = torch.arange(window, device=x.device)[None, :]
    return running[starts + window - lags, lags] - running[starts, lags]
