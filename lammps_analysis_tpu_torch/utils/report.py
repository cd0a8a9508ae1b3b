"""Environment report.

Counterpart of ``lammps_analysis_tpu/utils/report.py`` (the reference's
scooby-based report, ``mdsuite/utils/report_computer_characteristics.py:37``):
Python, the platform, numpy, scipy, torch and its CUDA, the CUDA devices and
the card's name and power limit from ``nvidia-smi``, as a printable summary.
"""

from __future__ import annotations

import os
import platform
import shutil
import subprocess
import sys

import torch


class Report:
    """Collect and render environment information."""

    def __init__(self, additional: dict = None):
        self.info = self._collect()
        if additional:
            self.info.update(additional)

    @staticmethod
    def _collect() -> dict:
        info = {
            "python": sys.version.split()[0],
            "platform": platform.platform(),
            "machine": platform.machine(),
            "cpu_count": os.cpu_count(),
        }
        for mod in ("numpy", "scipy"):
            try:
                info[mod] = __import__(mod).__version__
            except ImportError:  # pragma: no cover
                info[mod] = "unavailable"
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda or "none (a CPU build of torch)"
        info["devices"] = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        smi = shutil.which("nvidia-smi")
        if smi is not None:
            try:
                out = subprocess.run(
                    [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    capture_output=True, text=True, timeout=30, check=True,
                )
                info["nvidia_smi"] = out.stdout.strip().splitlines()
            except (OSError, subprocess.SubprocessError) as err:
                info["nvidia_smi"] = f"unavailable ({err})"
        return info

    def __repr__(self) -> str:
        width = max(len(k) for k in self.info)
        lines = [f"{k.rjust(width)} : {v}" for k, v in sorted(self.info.items())]
        return "\n".join(["lammps_analysis_tpu_torch environment report", "-" * 40, *lines])
