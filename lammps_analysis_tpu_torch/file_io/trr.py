"""Native GROMACS TRR binary trajectory reader.

Copied from ``lammps_analysis_tpu/file_io/trr.py``.

The reference reads GROMACS binaries only through chemfiles
(``mdsuite/file_io/chemfiles_read.py:44-98``); this implements the TRR
(XDR, big-endian) format directly from the GROMACS ``xdrfile_trr.c``
wire layout:

per frame:
    int32 magic = 1993
    int32 slen = 13                      (sizeof "GMX_trn_file")
    XDR string: int32 n + n bytes padded to a multiple of 4
    int32 ir_size, e_size, box_size, vir_size, pres_size, top_size,
          sym_size, x_size, v_size, f_size, natoms, step, nre
    float/double t, lambda               (precision from box/x sizes)
    [box: 9 floats]  [vir: 9]  [pres: 9]
    [x: natoms*3]  [v: natoms*3]  [f: natoms*3]

Precision per frame is derived exactly as ``nFloatSize`` does: from
``box_size / 9`` when a box is present, else ``x_size / (3 natoms)``.
Unit conventions follow the chemfiles-standardised ones already used by
the ``.gro`` reader: lengths nm -> Angstrom (x10), velocities nm/ps ->
A/ps (x10); forces (kJ/mol/nm) are stored as kJ/mol/A (/10).

TRR carries no species names: pass ``species`` as ``{name: [atom
indices]}``; by default all atoms form one species ``"X"``.
"""

from __future__ import annotations

import logging
import pathlib
import struct
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..database.contracts import (
    SpeciesInfo,
    TrajectoryChunkData,
    TrajectoryMetadata,
)
from ..database.properties import mdsuite_properties as mp
from .base import FileProcessor

log = logging.getLogger(__name__)

MAGIC = 1993
NM_TO_ANGSTROM = 10.0


class TRRFile(FileProcessor):
    """Reader for GROMACS TRR trajectories."""

    def __init__(
        self,
        file_path,
        species: Optional[Dict[str, List[int]]] = None,
        sample_rate: Optional[int] = None,
    ):
        super().__init__()
        self.file_path = pathlib.Path(file_path)
        self._species_arg = species
        self._sample_rate = sample_rate
        self._index = None  # list of per-frame dicts

    # ----------------------------------------------------------- frame index
    def _read_header(self, f):
        """Parse one frame header at the current offset; None at EOF."""
        raw = f.read(4)
        if len(raw) == 0:
            return None
        if len(raw) < 4:
            raise ValueError(f"{self.file_path}: truncated TRR header")
        (magic,) = struct.unpack(">i", raw)
        if magic != MAGIC:
            raise ValueError(
                f"{self.file_path}: bad TRR magic {magic} (expected {MAGIC})"
            )
        (slen,) = struct.unpack(">i", f.read(4))
        if not 8 <= slen <= 64:
            raise ValueError(f"{self.file_path}: implausible version length {slen}")
        (n,) = struct.unpack(">i", f.read(4))
        pad = -n % 4
        version = f.read(n + pad)[:n]
        if not version.startswith(b"GMX"):
            raise ValueError(
                f"{self.file_path}: unexpected version string {version!r}"
            )
        ints = struct.unpack(">13i", f.read(52))
        (ir_size, e_size, box_size, vir_size, pres_size, top_size,
         sym_size, x_size, v_size, f_size, natoms, step, nre) = ints
        if natoms <= 0:
            raise ValueError(f"{self.file_path}: natoms {natoms} <= 0")
        # nFloatSize (xdrfile_trr.c): box first, then x, then v, then f
        if box_size:
            fsize = box_size // 9
        elif x_size:
            fsize = x_size // (3 * natoms)
        elif v_size:
            fsize = v_size // (3 * natoms)
        elif f_size:
            fsize = f_size // (3 * natoms)
        else:
            raise ValueError(f"{self.file_path}: frame holds no data")
        if fsize not in (4, 8):
            raise ValueError(f"{self.file_path}: bad float size {fsize}")
        t_lambda = f.read(2 * fsize)
        fmt = ">d" if fsize == 8 else ">f"
        (t,) = struct.unpack(fmt, t_lambda[:fsize])
        hdr = {
            "natoms": natoms,
            "step": step,
            "t": t,
            "fsize": fsize,
            "box_size": box_size,
            "vir_size": vir_size,
            "pres_size": pres_size,
            "x_size": x_size,
            "v_size": v_size,
            "f_size": f_size,
            "data_offset": f.tell(),
        }
        if ir_size or e_size or top_size or sym_size:
            raise ValueError(
                f"{self.file_path}: legacy ir/e/top/sym blocks are not "
                "supported"
            )
        return hdr

    def _scan(self):
        if self._index is not None:
            return self._index
        index = []
        with open(self.file_path, "rb") as f:
            while True:
                hdr = self._read_header(f)
                if hdr is None:
                    break
                body = (
                    hdr["box_size"] + hdr["vir_size"] + hdr["pres_size"]
                    + hdr["x_size"] + hdr["v_size"] + hdr["f_size"]
                )
                f.seek(hdr["data_offset"] + body)
                index.append(hdr)
        if not index:
            raise ValueError(f"{self.file_path}: no frames")
        n0 = index[0]["natoms"]
        for h in index:
            if h["natoms"] != n0:
                raise ValueError(
                    f"{self.file_path}: varying atom counts "
                    f"({n0} vs {h['natoms']})"
                )
        self._index = index
        return index

    def _species_layout(self, natoms):
        if self._species_arg is None:
            return {"X": np.arange(natoms, dtype=np.intp)}
        out = {}
        seen = np.zeros(natoms, dtype=bool)
        for name, idx in self._species_arg.items():
            arr = np.asarray(list(idx), dtype=np.intp)
            if arr.size and (arr.min() < 0 or arr.max() >= natoms):
                raise ValueError(
                    f"species {name!r}: atom indices outside [0, {natoms})"
                )
            if seen[arr].any():
                raise ValueError(f"species {name!r}: overlapping atom indices")
            seen[arr] = True
            out[name] = arr
        if not seen.all():
            raise ValueError(
                f"species map covers {int(seen.sum())} of {natoms} atoms; "
                "every atom needs a species"
            )
        return out

    def _props(self, index):
        props = []
        if all(h["x_size"] for h in index):
            props.append(mp.positions)
        if all(h["v_size"] for h in index):
            props.append(mp.velocities)
        if all(h["f_size"] for h in index):
            props.append(mp.forces)
        if not props:
            raise ValueError(
                f"{self.file_path}: no property present in every frame"
            )
        return props

    def _get_metadata(self) -> TrajectoryMetadata:
        index = self._scan()
        natoms = index[0]["natoms"]
        species = self._species_layout(natoms)
        props = self._props(index)
        box_l = None
        h0 = index[0]
        if h0["box_size"]:
            with open(self.file_path, "rb") as f:
                f.seek(h0["data_offset"])
                fsize = h0["fsize"]
                dt = np.dtype(">f8" if fsize == 8 else ">f4")
                box = np.frombuffer(f.read(9 * fsize), dtype=dt).reshape(3, 3)
                off_diag = box - np.diag(np.diag(box))
                diag_scale = max(float(np.max(np.abs(np.diag(box)))), 1e-30)
                if float(np.max(np.abs(off_diag))) > 1e-6 * diag_scale:
                    # a triclinic box silently reduced to its diagonal
                    # would skew every minimum-image analysis downstream;
                    # fail loudly (orthorhombic-only, like the DCD reader)
                    raise ValueError(
                        f"{self.file_path}: triclinic TRR box (non-zero "
                        f"off-diagonal elements {off_diag.tolist()}) — only "
                        "orthorhombic boxes are supported"
                    )
                box_l = [float(box[i, i]) * NM_TO_ANGSTROM for i in range(3)]
        sample_rate = self._sample_rate
        if sample_rate is None and len(index) > 1:
            sample_rate = max(index[1]["step"] - index[0]["step"], 1)
        return TrajectoryMetadata(
            n_configurations=len(index),
            species_list=[
                SpeciesInfo(name, len(idx), list(props))
                for name, idx in species.items()
            ],
            box_l=box_l,
            sample_rate=sample_rate,
        )

    # -------------------------------------------------------------- streaming
    def get_configurations_generator(self) -> Iterator[TrajectoryChunkData]:
        index = self._scan()
        meta = self.metadata
        natoms = index[0]["natoms"]
        species = self._species_layout(natoms)
        props = self._props(index)
        frame_bytes = natoms * 3 * 8 * len(props)
        frames_per_chunk = max(1, (64 << 20) // max(frame_bytes, 1))
        scale = {
            mp.positions.name: NM_TO_ANGSTROM,
            mp.velocities.name: NM_TO_ANGSTROM,
            mp.forces.name: 1.0 / NM_TO_ANGSTROM,
        }
        with open(self.file_path, "rb") as f:
            for start in range(0, len(index), frames_per_chunk):
                frames = index[start:start + frames_per_chunk]
                chunk = TrajectoryChunkData(meta.species_list, len(frames))
                arrays = {
                    p.name: np.empty((len(frames), natoms, 3)) for p in props
                }
                for k, h in enumerate(frames):
                    fsize = h["fsize"]
                    dt = np.dtype(">f8" if fsize == 8 else ">f4")
                    off = h["data_offset"] + h["box_size"] + h["vir_size"] + h["pres_size"]
                    f.seek(off)
                    for name, size_key in (
                        (mp.positions.name, "x_size"),
                        (mp.velocities.name, "v_size"),
                        (mp.forces.name, "f_size"),
                    ):
                        size = h[size_key]
                        if not size:
                            continue
                        raw = f.read(size)
                        if name in arrays:
                            arrays[name][k] = np.frombuffer(
                                raw, dtype=dt
                            ).reshape(natoms, 3)
                for p in props:
                    data = arrays[p.name] * scale[p.name]
                    for sp in meta.species_list:
                        chunk.add_data(
                            data[:, species[sp.name], :], 0, sp.name, p.name
                        )
                yield chunk
