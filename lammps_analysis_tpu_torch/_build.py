"""Build and load the port's CUDA kernels from the sources in ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, for Hopper (``sm_90a``), which the wrappers load with ``ctypes``.
The library goes to ``_build/`` beside this file (ignored by git) under a
name that carries a hash of the sources and flags, so a stale library is
never loaded. The build runs at the first CUDA use, under a file lock, so
concurrent processes build once. A failed build raises with nvcc's stderr;
nothing falls back.

Flags: ``-fmad=false`` keeps ``a*b + c`` as two rounded operations, as
PyTorch's elementwise ops compute them, so the kernels agree bin for bin
with their plain torch versions; ``--use_fast_math`` is never used.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def _nvcc() -> str:
    candidates = [
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
        "CUDA kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libport_kernels-{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their joined output, or raise on a failure."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}: {' '.join(cmd)}\n{out}"
            )
    return "".join(outputs)


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists.

    One nvcc per source, all started together, then one link. nvcc's output
    (ptxas register and shared-memory usage) is kept beside the library as
    ``<library>.log``.
    """
    path = library_path()
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if path.exists():
            return path
        tag = f"{path.stem}.{os.getpid()}"
        objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
        tmp = path.with_name(f"{tag}.so.tmp")
        nvcc = _nvcc()
        try:
            log = _run_all([
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(_sources(), objects)
            ])
            log += _run_all([[nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]])
            path.with_name(path.name + ".log").write_text(log)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
            for obj in objects:
                obj.unlink(missing_ok=True)
    return path


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once per process."""
    global _library
    with _lock:
        if _library is None:
            _library = ctypes.CDLL(str(build()))
        return _library
