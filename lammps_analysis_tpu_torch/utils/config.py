"""Global configuration singleton for the PyTorch/CUDA port.

Counterpart of ``lammps_analysis_tpu/utils/config.py``. The compile-cache
hook of the JAX package has no counterpart here (PyTorch runs eagerly and
the CUDA kernels build once per checkout, see ``_build.py``). What is new
is ``device``: every device-side tensor of the port lives on
``torch.device(config.device)``, and the default is the GPU.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    """Global runtime configuration.

    Attributes
    ----------
    device : str
        Torch device string for all device-side work (``"cuda"``,
        ``"cuda:1"``, ``"cpu"``). Defaults to ``"cuda"``; when no GPU is
        present the first device use raises instead of quietly running on
        the CPU. Set ``"cpu"`` explicitly to run the plain torch path.
    jupyter : bool
        Whether we are running inside a notebook (affects progress bars only).
    memory_fraction : float
        Fraction of host RAM the batch planner may plan into on the CPU.
    device_memory_fraction : float
        Fraction of the GPU's memory the planner may fill with trajectory
        data.
    fuse_streaming : bool
        If True, calculators that stream ``Unwrapped_Positions`` unwrap the
        wrapped positions on the fly (the carry chained across slabs) when
        the unwrapped dataset is not materialised, skipping one
        full-trajectory write and read. Results are identical to the
        materialised path (the unwrap is batch-size invariant); the trade is
        that no ``Unwrapped_Positions`` dataset is left behind for later
        reuse. Off by default (reference semantics).
    progress_bars : bool | None
        Progress bars on long loops; ``None`` means on only when stderr is a
        TTY or ``jupyter`` is set.
    """

    device: str = "cuda"
    jupyter: bool = False
    memory_fraction: float = 0.5
    device_memory_fraction: float = 0.6
    fuse_streaming: bool = False
    progress_bars: bool | None = None


config = Config()


def get_device() -> torch.device:
    """The configured device; raises if it is a GPU that is not there."""
    device = torch.device(config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"config.device is {config.device!r} but torch finds no CUDA "
            "device. The port does not fall back to the CPU on its own: set "
            "lammps_analysis_tpu_torch.config.device = 'cpu' to run the plain "
            "torch path."
        )
    return device
