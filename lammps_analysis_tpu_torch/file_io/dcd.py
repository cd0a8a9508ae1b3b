"""Native CHARMM/NAMD/LAMMPS DCD binary trajectory reader.

Copied from ``lammps_analysis_tpu/file_io/dcd.py``.

The reference ingests binary trajectories only through chemfiles
(``mdsuite/file_io/chemfiles_read.py:44-98``), a dependency this
environment does not ship; this is a from-scratch reader of the
published DCD format (CHARMM unformatted Fortran records), closing the
binary-ingestion gap natively.

Format (every record is ``[int32 nbytes][payload][int32 nbytes]``):

* header record (84 bytes): magic ``b"CORD"`` + 20 int32 control words
  (``icntrl``): [0]=n frames, [1]=first step, [2]=save interval,
  [8]=number of fixed atoms (unsupported here), [9]=timestep (float32 in
  CHARMM files, float64 in X-PLOR), [10]=unit-cell flag, [19]=CHARMM
  version (0 -> X-PLOR variant);
* title record: int32 count + count x 80-byte strings;
* natoms record: one int32;
* per frame: optional unit-cell record (6 float64 — the CHARMM ``XTLABC``
  lower triangle ``[A, gamma, B, beta, alpha, C]``; cosines of the
  angles in newer CHARMM, degrees in older — only the orthorhombic edge
  lengths are consumed here), then one record each of X, Y, Z
  (``natoms`` float32).

Byte order is auto-detected from the first record length (84 encodes
differently under the wrong endianness). The frame count trusts the file
size over ``icntrl[0]`` (appended/truncated files are common).
Coordinates are Angstroms in every producer this format matters for
(CHARMM, NAMD, OpenMM, LAMMPS ``dump dcd``) and pass through unchanged.

DCD carries no species/topology information: pass ``species`` as
``{name: [atom indices]}`` (the same convention as ``atom_selection``);
by default all atoms become one species ``"X"``.
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


class DCDFile(FileProcessor):
    """Reader for DCD binary trajectories."""

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
        self._layout = None

    # ------------------------------------------------------------ header scan
    def _scan(self):
        if self._layout is not None:
            return self._layout
        with open(self.file_path, "rb") as f:
            first = f.read(4)
            if len(first) < 4:
                raise ValueError(f"{self.file_path}: not a DCD file (too short)")
            (n_le,) = struct.unpack("<i", first)
            if n_le == 84:
                bo = "<"
            elif struct.unpack(">i", first)[0] == 84:
                bo = ">"
            else:
                raise ValueError(
                    f"{self.file_path}: first record length {n_le} != 84 — "
                    "not a DCD file"
                )
            hdr = f.read(84)
            (tail,) = struct.unpack(bo + "i", f.read(4))
            if tail != 84 or hdr[:4] != b"CORD":
                raise ValueError(f"{self.file_path}: malformed DCD header")
            icntrl = struct.unpack(bo + "20i", hdr[4:])
            if icntrl[8] != 0:
                raise ValueError(
                    f"{self.file_path}: fixed-atom DCD files (NAMNF = "
                    f"icntrl[8] = {icntrl[8]}) are not supported"
                )
            has_cell = icntrl[10] != 0
            charmm = icntrl[19] != 0
            if charmm and icntrl[11] != 0:
                # CHARMM 4D flag: such files carry a per-frame fourth
                # coordinate record, so frame_bytes below would be wrong
                # and every frame would mis-parse into garbage — fail
                # loudly like the NAMNF check above
                raise ValueError(
                    f"{self.file_path}: CHARMM 4D-coordinate DCD files "
                    f"(icntrl[11] = {icntrl[11]}) are not supported"
                )
            if charmm:
                (delta,) = struct.unpack(bo + "f", hdr[4 + 9 * 4:4 + 10 * 4])
            else:
                # X-PLOR stores the timestep as a float64 spanning two slots
                (delta,) = struct.unpack(bo + "d", hdr[4 + 9 * 4:4 + 11 * 4])
                has_cell = False  # the cell flag is CHARMM-only

            def record(expect: Optional[int] = None) -> bytes:
                raw = f.read(4)
                if len(raw) < 4:
                    raise ValueError(f"{self.file_path}: truncated DCD")
                (n,) = struct.unpack(bo + "i", raw)
                if expect is not None and n != expect:
                    raise ValueError(
                        f"{self.file_path}: record of {n} bytes where "
                        f"{expect} expected"
                    )
                payload = f.read(n)
                (tail,) = struct.unpack(bo + "i", f.read(4))
                if tail != n:
                    raise ValueError(f"{self.file_path}: record framing broken")
                return payload

            record()  # title block
            (natoms,) = struct.unpack(bo + "i", record(4))
            header_end = f.tell()

        frame_bytes = 3 * (4 * natoms + 8) + (48 + 8 if has_cell else 0)
        data_bytes = self.file_path.stat().st_size - header_end
        n_frames = data_bytes // frame_bytes
        if n_frames * frame_bytes != data_bytes:
            log.warning(
                "%s: %d trailing bytes beyond the last whole frame "
                "(truncated write?) — ignored",
                self.file_path, data_bytes - n_frames * frame_bytes,
            )
        if icntrl[0] and icntrl[0] != n_frames:
            log.info(
                "%s: header claims %d frames, file holds %d; trusting the "
                "file", self.file_path, icntrl[0], n_frames,
            )
        box_l = None
        if has_cell and n_frames > 0:
            with open(self.file_path, "rb") as f:
                f.seek(header_end + 4)
                xtlabc = struct.unpack(bo + "6d", f.read(48))
                box_l = [xtlabc[0], xtlabc[2], xtlabc[5]]
        self._layout = {
            "bo": bo,
            "natoms": int(natoms),
            "has_cell": has_cell,
            "n_frames": int(n_frames),
            "header_end": header_end,
            "frame_bytes": frame_bytes,
            "box_l": box_l,
            "sample_rate": self._sample_rate or (icntrl[2] or 1),
        }
        return self._layout

    def _species_layout(self):
        lay = self._scan()
        if self._species_arg is None:
            return {"X": np.arange(lay["natoms"], dtype=np.intp)}
        out = {}
        seen = np.zeros(lay["natoms"], dtype=bool)
        for name, idx in self._species_arg.items():
            arr = np.asarray(list(idx), dtype=np.intp)
            if arr.size and (arr.min() < 0 or arr.max() >= lay["natoms"]):
                raise ValueError(
                    f"species {name!r}: atom indices outside "
                    f"[0, {lay['natoms']})"
                )
            if seen[arr].any():
                raise ValueError(f"species {name!r}: overlapping atom indices")
            seen[arr] = True
            out[name] = arr
        if not seen.all():
            raise ValueError(
                f"species map covers {int(seen.sum())} of {lay['natoms']} "
                "atoms; every atom needs a species"
            )
        return out

    def _get_metadata(self) -> TrajectoryMetadata:
        lay = self._scan()
        species = self._species_layout()
        props = [mp.positions]
        species_list = [
            SpeciesInfo(name, len(idx), list(props))
            for name, idx in species.items()
        ]
        return TrajectoryMetadata(
            n_configurations=lay["n_frames"],
            species_list=species_list,
            box_l=lay["box_l"],
            sample_rate=lay["sample_rate"],
        )

    # -------------------------------------------------------------- streaming
    def get_configurations_generator(self) -> Iterator[TrajectoryChunkData]:
        lay = self._scan()
        species = self._species_layout()
        meta = self.metadata
        natoms, bo = lay["natoms"], lay["bo"]
        # ~64 MB of frames per chunk
        frames_per_chunk = max(1, (64 << 20) // max(lay["frame_bytes"], 1))
        f32 = np.dtype(np.float32).newbyteorder(bo)
        with open(self.file_path, "rb") as f:
            f.seek(lay["header_end"])
            done = 0
            while done < lay["n_frames"]:
                n = min(frames_per_chunk, lay["n_frames"] - done)
                raw = f.read(n * lay["frame_bytes"])
                block = np.frombuffer(raw, dtype=np.uint8).reshape(
                    n, lay["frame_bytes"]
                )
                off = 48 + 8 if lay["has_cell"] else 0
                xyz = np.empty((n, natoms, 3), dtype=np.float64)
                for d in range(3):
                    start = off + d * (4 * natoms + 8) + 4
                    comp = block[:, start:start + 4 * natoms]
                    xyz[:, :, d] = (
                        np.ascontiguousarray(comp).view(f32).astype(np.float64)
                    )
                chunk = TrajectoryChunkData(meta.species_list, n)
                for sp in meta.species_list:
                    chunk.attach_data(
                        np.ascontiguousarray(xyz[:, species[sp.name], :]),
                        sp.name, mp.positions.name,
                    )
                done += n
                yield chunk
