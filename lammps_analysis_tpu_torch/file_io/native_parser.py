"""ctypes bridge to the native C++ table parser ``native/table_parser.cpp``.

Counterpart of ``lammps_analysis_tpu/file_io/native_parser.py``. The source
is compiled where it is, unchanged, with ``g++ -O3 -march=native -shared
-fPIC -std=c++17``, into ``_build/`` beside the kernels (ignored by git),
under a name that carries a hash of the source, the flags and the host CPU,
and under the same file lock as ``_build.py``: concurrent processes build
once, and a library built for one CPU is never loaded on another. Nothing
is written into ``native/``. A failed build or load raises with the
compiler's output; there is no other engine to fall back to. ``build`` takes
another source of ``native/`` too (``chip_smoke.py`` builds the native SDF
kernel with it, as a bar for the card).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from .._build import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "table_parser.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _host_cpu() -> bytes:
    """The host CPU's model and flags (what ``-march=native`` compiles for)."""
    try:
        lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))][:2]
    return "\n".join(keep).encode()


def library_path(source: pathlib.Path | None = None) -> pathlib.Path:
    """Where the library of ``source`` (the parser by default), for these
    flags and this CPU, lives."""
    source = SOURCE if source is None else source
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(source.read_bytes())
    digest.update(_host_cpu())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"


def build(source: pathlib.Path | None = None) -> pathlib.Path:
    """Compile ``source`` (the parser by default) unless a library for it and
    this CPU exists. Other host sources of ``native/`` build the same way."""
    source = SOURCE if source is None else source
    what = source.stem.replace("_", "-")
    path = library_path(source)
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if path.exists():
            return path
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.so.tmp")
        cmd = ["g++", *GXX_FLAGS, str(source), "-o", str(tmp)]
        try:
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except OSError as err:
                raise RuntimeError(
                    f"cannot run the {what} build {' '.join(cmd)}: {err}"
                ) from err
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{what} build failed with exit code {proc.returncode}: "
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
    return path


def _load() -> ctypes.CDLL:
    """The parser library, built on first call and loaded once per process."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.parse_table_block.restype = ctypes.c_long
        lib.parse_table_block.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.parse_table_block_by_id.restype = ctypes.c_long
        lib.parse_table_block_by_id.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.parse_scatter_f32.restype = ctypes.c_long
        lib.parse_scatter_f32.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.offset_after_nth_newline.restype = ctypes.c_long
        lib.offset_after_nth_newline.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ]
        lib.count_newlines.restype = ctypes.c_long
        lib.count_newlines.argtypes = [ctypes.c_char_p, ctypes.c_long]
        _lib = lib
        return _lib


def parse_table_block(
    text: bytes,
    n_configs: int,
    n_header_lines: int,
    n_particles: int,
    n_cols: int,
    id_col: int | None = None,
) -> np.ndarray:
    """Parse a raw text block -> (n_configs, n_particles, n_cols) float64.

    Non-numeric tokens (element columns) come back as NaN. With ``id_col``
    set, rows are placed by their integer id (1..n_particles) inside the
    single native pass; ids outside that range are sorted on the host.
    """
    lib = _load()
    out = np.empty((n_configs, n_particles, n_cols), dtype=np.float64)
    out_ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    if id_col is not None:
        written = lib.parse_table_block_by_id(
            text, len(text), n_configs, n_header_lines, n_particles,
            n_cols, id_col, out_ptr,
        )
        if written == out.size:
            return out
        if written not in (-2, -3):
            raise ValueError(
                f"native parser wrote {written} values, expected {out.size} "
                "(truncated or malformed block)"
            )
    written = lib.parse_table_block(
        text, len(text), n_configs, n_header_lines, n_particles, n_cols,
        out_ptr,
    )
    if written != out.size:
        raise ValueError(
            f"native parser wrote {written} values, expected {out.size} "
            "(truncated or malformed block)"
        )
    if id_col is not None:
        # ids not 1..N: sort on the host
        order = np.argsort(out[:, :, id_col], axis=1, kind="stable")
        out = np.take_along_axis(out, order[:, :, None], axis=1)
    return out


class ScatterLayout:
    """Precomputed destination layout for :func:`parse_scatter_f32`.

    Built once per reader spec: sorted row -> (species index, row within
    species), per-property column lists, species row counts.
    """

    def __init__(self, species_to_line_idx, property_to_column_idx,
                 species_order, prop_order):
        n_particles = sum(len(v) for v in species_to_line_idx.values())
        self.species_order = list(species_order)
        self.prop_order = list(prop_order)
        row_species = np.empty(n_particles, dtype=np.int32)
        row_dest = np.empty(n_particles, dtype=np.int32)
        sp_rows = np.empty(len(self.species_order), dtype=np.int64)
        for s, name in enumerate(self.species_order):
            rows = np.asarray(species_to_line_idx[name], dtype=np.intp)
            row_species[rows] = s
            row_dest[rows] = np.arange(len(rows), dtype=np.int32)
            sp_rows[s] = len(rows)
        cols_flat, off = [], [0]
        for pname in self.prop_order:
            cols = list(property_to_column_idx[pname])
            cols_flat.extend(cols)
            off.append(len(cols_flat))
        self.row_species = row_species
        self.row_dest = row_dest
        self.sp_rows = sp_rows
        self.prop_cols = np.asarray(cols_flat, dtype=np.int32)
        self.prop_off = np.asarray(off, dtype=np.int32)
        self.prop_dims = [
            int(self.prop_off[i + 1] - self.prop_off[i])
            for i in range(len(self.prop_order))
        ]


def parse_scatter_f32(
    text: bytes,
    n_configs: int,
    n_header_lines: int,
    n_particles: int,
    n_cols: int,
    layout: ScatterLayout,
    id_col: int | None = None,
):
    """Parse a block straight into per-(species, property) f32 buffers.

    Returns ``{(species, prop): (n_configs, n_sp, d) float32 array}`` or
    ``None`` when the block's atom ids are not 1..N; callers then take
    :func:`parse_table_block`, which sorts on the host. Only the id and
    property columns are parsed; the rest (the element column) is skipped.
    """
    lib = _load()
    n_props = len(layout.prop_order)
    bufs = {}
    ptrs = (ctypes.c_void_p * (len(layout.species_order) * n_props))()
    for s, sname in enumerate(layout.species_order):
        for p, pname in enumerate(layout.prop_order):
            arr = np.empty(
                (n_configs, int(layout.sp_rows[s]), layout.prop_dims[p]),
                dtype=np.float32,
            )
            bufs[(sname, pname)] = arr
            ptrs[s * n_props + p] = arr.ctypes.data_as(ctypes.c_void_p)
    rc = lib.parse_scatter_f32(
        text, len(text), n_configs, n_header_lines, n_particles, n_cols,
        -1 if id_col is None else int(id_col),
        layout.row_species.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        layout.row_dest.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_props,
        layout.prop_cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        layout.prop_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        layout.sp_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ptrs,
    )
    if rc == -2:
        return None  # ids not 1..N, or duplicated
    if rc < 0:
        raise ValueError(
            f"native scatter parser failed (rc={rc}): truncated block?"
        )
    return bufs


def count_newlines(text: bytes) -> int:
    return _load().count_newlines(text, len(text))


def offset_after_nth_newline(text: bytes, n: int) -> int:
    """Byte offset just past the n-th newline (-1 if fewer exist)."""
    return _load().offset_after_nth_newline(text, len(text), n)
