"""FFT-based windowed autocorrelation and cross-correlation.

Counterpart of ``acf_biased``, ``windowed_acf_sum``,
``cross_correlation_biased`` and ``window_starts`` in
``lammps_analysis_tpu/ops/correlation.py`` in torch ops on the tensor's
device (``torch.fft``). The reference computes windowed autocorrelations with
``tfp.stats.auto_correlation(..., center=False, normalize=False)`` per sliding
window; ``acf = irfft(|rfft(x, 2T)|^2)[:T] / T`` is the same biased estimator
(denominator ``T`` for every lag), batched over windows, particles and
components.

Precision: the forward FFTs run in the data's dtype (float32 from the store);
the power spectra are summed over particles and components in float64 and
inverted once per window in float64.

Each FFT batch of ``windowed_acf_sum`` is three steps: ``acf_pack`` writes
the batch's windows, zero-padded, into a contiguous ``(B, N*D, L)`` buffer;
``torch.fft.rfft`` (cuFFT on the card) transforms it; ``acf_power_sum`` sums
the squared spectrum over the sequences in float64. On a CUDA tensor the
first and the last are the kernels of ``csrc/acf_power.cu``, and the buffer
is allocated once a call, its zero tail written by the first batch alone; on
a CPU tensor they are their plain torch versions, ``acf_pack_reference`` and
``acf_power_sum_reference``. A CUDA tensor never takes the plain versions.

``windowed_acf_sum`` runs each FFT batch in the span ``acf.batch`` and counts
``acf.windows``, ``acf.batches`` and ``acf.sequences`` (windows x particles
x components); the kernels count ``acf.pack.launches`` and
``acf.power.launches``, the plain power sum ``acf.plain`` (one a batch)
(``utils/profiling.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..utils import profiling


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


def acf_biased(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Biased autocorrelation along ``dim``: the ``y = x`` case of
    :func:`cross_correlation_biased`.

    ``acf[m] = (1/T) * sum_{t=0}^{T-1-m} x[t] * x[t+m]``, identical to
    ``tfp.stats.auto_correlation(x, center=False, normalize=False)`` used
    throughout the reference Green-Kubo calculators.
    """
    return cross_correlation_biased(x, x, dim)


def to_host(*tensors: torch.Tensor) -> list:
    """The tensors as numpy arrays on the host. From a CUDA device each is
    copied into page-locked memory (``non_blocking``), then the stream is
    waited on once: a DMA whose time does not hang on the host CPU's copy
    into pageable pages, as ``.cpu()``'s does (the per-window ACFs of a
    system series, 6 MB a call at 1501 windows of 500 lags)."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.detach().cpu().numpy() for t in tensors]
    out = []
    for t in tensors:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        out.append(host.copy_(t, non_blocking=True))
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [t.numpy() for t in out]


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
    x = x.contiguous()
    lags = None if tau is None else lag_table(tau, window, x.device)
    acf_sum = torch.zeros(r, dtype=torch.float64, device=x.device)
    per_window = []
    profiling.count("acf.windows", n_windows)
    profiling.count("acf.sequences", n_windows * n_particles * n_dims)
    buf = None  # the first batch's buffer, the largest; later batches reuse it
    for c0 in range(0, n_windows, chunk):
        with profiling.annotate("acf.batch"):
            packed = acf_pack(x, window, stride, c0, min(chunk, n_windows - c0), fft_len,
                              lags, out=buf)
            buf = packed if buf is None else buf
            # irfft is linear: sum the power spectra over particles and
            # components FIRST and invert once per window
            power = acf_power_sum(torch.fft.rfft(packed, n=fft_len, dim=-1))
            acf = torch.fft.irfft(power, n=fft_len, dim=-1)[:, :r] / r  # sum over N, D
            acf_sum += acf.sum(0)
            per_window.append(acf / n_particles)
        profiling.count("acf.batches")
    return acf_sum, torch.cat(per_window)


def lag_table(tau, window: int, device) -> torch.Tensor:
    """``tau`` as the ``(R,)`` int32 lag table ``acf_pack`` takes, on
    ``device``: checked on the host to lie in ``[0, window)``, since the
    kernel reads the slab at each lag unchecked."""
    lags = torch.as_tensor(tau, dtype=torch.long, device="cpu").reshape(-1)
    if lags.numel() and not (0 <= int(lags.min()) and int(lags.max()) < window):
        raise ValueError(
            f"tau must lie in [0, {window}) (the window's lags), got "
            f"[{int(lags.min())}, {int(lags.max())}]"
        )
    return lags.to(device=device, dtype=torch.int32)


#: columns of one power-sum block; must equal ``kPowerThreads * kSlots``
POWER_COLUMNS = 640
#: least sequences in a chunk of the power sum: a chunk's partial row (8 F
#: bytes) stays under 1/64 of what it reads (8 F bytes a sequence)
POWER_MIN_ROWS = 64
#: power-sum blocks an SM is given, where the shape has that many chunks:
#: four waves of 8 resident blocks, so the last wave's tail is short
POWER_BLOCKS_PER_SM = 32


def power_split(n_windows: int, n_seq: int, n_freq: int, n_sms: int) -> tuple[int, int]:
    """``(chunks, rows)``: the power sum cuts each window's ``n_seq >= 1``
    sequences into ``chunks`` chunks of ``rows`` (the last may be shorter,
    none empty), enough blocks to give each of ``n_sms`` SMs
    ``POWER_BLOCKS_PER_SM``, but chunks of at least ``POWER_MIN_ROWS``
    sequences (one chunk below that): many a window where windows are few
    and sequences many (GK self-diffusion, 32 x 48000), one where windows
    are many and sequences few (a system series, thousands x 3)."""
    col_tiles = -(-n_freq // POWER_COLUMNS)
    wanted = -(-POWER_BLOCKS_PER_SM * n_sms // (n_windows * col_tiles))
    chunks = max(1, min(wanted, n_seq // POWER_MIN_ROWS))
    rows = -(-n_seq // chunks)
    return -(-n_seq // rows), rows


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load_library()
    lib.acf_pack_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.acf_pack_launch.restype = ctypes.c_int
    lib.acf_power_sum_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 5 + [
        ctypes.c_void_p]
    lib.acf_power_sum_launch.restype = ctypes.c_int
    lib.rdf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rdf_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({_library().rdf_cuda_error_string(err).decode()})"
        )


def _check_pack(x, window, stride, c0, n, fft_len, lags, out) -> int:
    """The lags a window packs (``R``), after the shapes are checked."""
    if not isinstance(x, torch.Tensor) or not x.is_floating_point() or x.dim() != 3:
        raise TypeError("x must be a (T, N, D) floating-point tensor")
    r = window if lags is None else lags.numel()
    if not (window >= 1 and stride >= 1 and c0 >= 0 and n >= 1 and fft_len >= r):
        raise ValueError(
            f"need window, stride, n >= 1, c0 >= 0, fft_len >= R; got {window}, {stride}, "
            f"{n}, {c0}, {fft_len} (R = {r})"
        )
    if (c0 + n - 1) * stride + window > x.shape[0]:
        raise ValueError(
            f"windows {c0}..{c0 + n - 1} of {window} frames every {stride} pass the "
            f"{x.shape[0]} frames of x"
        )
    if lags is not None and (lags.dim() != 1 or lags.device != x.device
                             or lags.dtype not in (torch.int32, torch.int64)):
        raise ValueError("lags must be a 1-D integer tensor on x's device (lag_table)")
    shape = (n, x.shape[1] * x.shape[2], fft_len)
    if out is not None and (out.dtype != x.dtype or out.device != x.device
                            or not out.is_contiguous() or out.shape[0] < n
                            or tuple(out.shape[1:]) != shape[1:]):
        raise ValueError(
            f"out must be a contiguous {x.dtype} (>= {n}, {shape[1]}, {fft_len}) tensor "
            f"on {x.device}, got {out.dtype} {tuple(out.shape)} on {out.device}"
        )
    return r


def acf_pack_reference(x, window, stride, c0, n, fft_len, lags=None, out=None):
    """Plain torch version of ``acf_pack`` (any device; the wrapper takes it
    for CPU tensors): the windows as a strided view of ``x``, gathered at
    ``lags``, zero-padded to ``fft_len``; with ``out``, written into its
    first ``n`` windows up to ``R``, its tail left as it is."""
    seg = x.unfold(0, window, stride)[c0 : c0 + n]  # (n, N, D, window): a view
    if lags is not None:
        seg = seg.index_select(-1, lags)
    r = seg.shape[-1]
    if out is None:
        return torch.nn.functional.pad(seg, (0, fft_len - r)).reshape(n, -1, fft_len)
    packed = out[:n]
    packed.view(seg.shape[:3] + (fft_len,))[..., :r].copy_(seg)
    return packed


def acf_pack(x, window, stride, c0, n, fft_len, lags=None, out=None) -> torch.Tensor:
    """Windows ``c0 .. c0 + n - 1`` of ``x``, zero-padded: ``(n, N*D,
    fft_len)`` contiguous, in ``x``'s dtype.

    ``x`` ``(T, N, D)``, float32 on the card; window ``c`` starts at frame
    ``c * stride`` and holds ``window`` frames. ``lags``: None for lags
    ``0 .. window - 1``, else the ``(R,)`` lag table (``lag_table``: int32
    on ``x``'s device, each in ``[0, window)``) at which each window is
    gathered. Element ``[b, s, k]`` is ``x[(c0 + b) * stride + lag_k]`` of
    sequence ``s = n_idx * D + d`` for ``k < R`` and 0 above.

    ``out``: the buffer an earlier call returned for the same ``x``'s
    sequences, lags and ``fft_len``, of at least ``n`` windows. Its first
    ``n`` windows are written up to ``R`` and returned: their tail keeps the
    zeros the earlier call wrote, cuFFT's out-of-place R2C leaving its
    input as it was. Without it a new buffer is allocated and its tail
    written.
    """
    r = _check_pack(x, window, stride, c0, n, fft_len, lags, out)
    if x.device.type == "cpu":
        return acf_pack_reference(x, window, stride, c0, n, fft_len, lags, out)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or (lags is not None and (
            lags.dtype != torch.int32 or not lags.is_contiguous())):
        raise ValueError("on the card x must be contiguous float32 and lags contiguous int32")
    n_seq = x.shape[1] * x.shape[2]
    tail = out is None
    packed = (torch.empty((n, n_seq, fft_len), dtype=torch.float32, device=x.device)
              if tail else out[:n])
    with torch.cuda.device(x.device):
        err = _library().acf_pack_launch(
            x.data_ptr(), None if lags is None else lags.data_ptr(), packed.data_ptr(),
            n_seq, r, fft_len, c0 * stride, stride, n, int(tail),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on(err, "acf_pack")
    profiling.count("acf.pack.launches")
    return packed


def acf_power_sum_reference(spec: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``acf_power_sum`` (any device; the wrapper
    takes it for CPU tensors). Squares ``spec`` in place, as the torch ops
    of the windowed ACF did, to keep one spectrum in memory. Counts
    ``acf.plain``."""
    profiling.count("acf.plain")
    return torch.sum(torch.view_as_real(spec).square_(), dim=(1, 3), dtype=torch.float64)


def acf_power_sum(spec: torch.Tensor) -> torch.Tensor:
    """``(B, F)`` float64: the power of the ``(B, S, F)`` spectrum (complex64
    on the card) summed over its ``S`` sequences, each ``re^2`` and ``im^2``
    rounded in the spectrum's precision and summed in float64. On the card
    the order of the float64 adds is fixed (``power_split``, no atomics): a
    run repeats bit for bit. The plain version squares ``spec`` in place;
    the kernel leaves it."""
    if not isinstance(spec, torch.Tensor) or not spec.is_complex() or spec.dim() != 3:
        raise TypeError("spec must be a (B, S, F) complex tensor")
    if not spec.is_contiguous():
        raise ValueError("spec must be contiguous")
    if spec.device.type == "cpu":
        return acf_power_sum_reference(spec)
    if spec.device.type != "cuda":
        raise ValueError(f"no kernel for device {spec.device}")
    if spec.dtype != torch.complex64:
        raise ValueError(f"on the card spec must be complex64, got {spec.dtype}")
    n_win, n_seq, n_freq = spec.shape
    power = torch.empty((n_win, n_freq), dtype=torch.float64, device=spec.device)
    if power.numel() == 0 or n_seq == 0:
        return power.zero_()
    with torch.cuda.device(spec.device):
        chunks, rows = power_split(n_win, n_seq, n_freq, _sm_count(torch.cuda.current_device()))
        scratch = (torch.empty((n_win, chunks, n_freq), dtype=torch.float64, device=spec.device)
                   if chunks > 1 else None)
        err = _library().acf_power_sum_launch(
            spec.data_ptr(), power.data_ptr(), None if scratch is None else scratch.data_ptr(),
            n_win, n_seq, n_freq, rows, chunks,
            torch.cuda.current_stream(spec.device).cuda_stream,
        )
    _raise_on(err, "acf_power_sum")
    profiling.count("acf.power.launches")
    return power
