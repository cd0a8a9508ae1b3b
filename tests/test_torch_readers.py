"""PyTorch port, the extxyz, GROMACS ``.gro`` / TRR, DCD and chemfiles
readers, held against the JAX package's readers on the same files.

The files come from the writers of ``tests/torch_water.py`` (a seeded
rigid-water walk) and from MDSuite's extxyz golden. Both packages' readers
must give the same metadata, the same species and, chunk by chunk, the same
arrays: the port's readers are copies, the extxyz reader on the port's
native tabular engine. The JAX package's error cases
(``tests/test_binary_readers.py``) raise alike. Each package gets its own
``tmp_path`` directory where it ingests.
"""

import json
import pathlib
import struct

import numpy as np
import pytest
import torch

from lammps_analysis_tpu import file_io as jax_io
from lammps_analysis_tpu.experiment.experiment import _processor_for_path as jax_processor_for_path
from lammps_analysis_tpu_torch import file_io
from lammps_analysis_tpu_torch.experiment.experiment import _processor_for_path
from lammps_analysis_tpu_torch.utils.config import config

import torch_water as tw
from torch_jax_parser import ensure_jax_native_parser

torch.set_num_threads(1)

GOLDENS = pathlib.Path(__file__).parent / "goldens"
BOX = 3 * 3.1067  # 27 waters at the water box's density


@pytest.fixture(scope="module", autouse=True)
def jax_reads_natively():
    ensure_jax_native_parser()


@pytest.fixture(autouse=True)
def cpu_device():
    old = config.device
    config.device = "cpu"
    yield
    config.device = old


@pytest.fixture(scope="module")
def water():
    return tw.water_box(3, 12, BOX, 0.1, seed=31)


def _describe(meta):
    return (
        meta.n_configurations,
        None if meta.box_l is None else [float(b) for b in meta.box_l],
        meta.sample_rate,
        [(sp.name, sp.n_particles, [p.name for p in sp.properties]) for sp in meta.species_list],
    )


def _assert_same_reading(ours, ref):
    """Equal metadata, then every chunk's arrays identical (dtype too)."""
    assert _describe(ours.metadata) == _describe(ref.metadata)
    chunks = list(ours.get_configurations_generator())
    ref_chunks = list(ref.get_configurations_generator())
    assert [c.chunk_size for c in chunks] == [c.chunk_size for c in ref_chunks]
    for chunk, ref_chunk in zip(chunks, ref_chunks):
        for sp in ref.metadata.species_list:
            for prop in sp.properties:
                a = np.asarray(chunk.get_data(sp.name, prop.name))
                b = np.asarray(ref_chunk.get_data(sp.name, prop.name))
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"{sp.name}/{prop.name}")
    return chunks


def _concat(chunks, species, prop):
    return np.concatenate([np.asarray(c.get_data(species, prop)) for c in chunks])


def _write(kind, path, w, **kw):
    """One file of the water walk, of each kind the tests read."""
    if kind == "extxyz":
        tw.write_extxyz(path, w["wrapped"], BOX)
    elif kind == "gro":
        tw.write_gro(path, w["wrapped"], BOX, velocities=w["velocities"] / 0.02)
    elif kind == "gro-no-velocities":
        tw.write_gro(path, w["wrapped"], BOX)
    elif kind in ("trr-single", "trr-double"):
        tw.write_trr(path, BOX, x=w["wrapped"], v=w["velocities"] / 0.02,
                     f=w["unwrapped"] * 3.0, double=kind == "trr-double")
    elif kind == "trr-positions-only":
        tw.write_trr(path, BOX, x=w["wrapped"])
    elif kind.startswith("dcd"):
        tw.write_dcd(path, w["wrapped"], BOX, bo=">" if kind == "dcd-big-endian" else "<", **kw)
    return path


def _readers(kind, path, species=None):
    name = {"ext": "EXTXYZFile", "gro": "GROFile", "trr": "TRRFile", "dcd": "DCDFile"}[kind[:3]]
    kw = {} if species is None else {"species": species}
    return getattr(file_io, name)(path, **kw), getattr(jax_io, name)(path, **kw)


# -------------------------------------------------------------- same reading
def test_extxyz_golden_matches_jax_and_mdsuite(tmp_path):
    """MDSuite's extxyz reader on the same text (``golden_extxyz_reader.json``)."""
    g = json.loads((GOLDENS / "golden_extxyz_reader.json").read_text())
    path = tmp_path / "t.extxyz"
    path.write_text(g["file_text"])
    ours, ref = file_io.EXTXYZFile(path), jax_io.EXTXYZFile(path)
    chunks = _assert_same_reading(ours, ref)
    meta = ours.metadata
    assert meta.n_configurations == g["n_configurations"]
    np.testing.assert_allclose(meta.box_l, g["box_l"])
    assert {sp.name: sp.n_particles for sp in meta.species_list} == {
        name: v["n_particles"] for name, v in g["species"].items()
    }
    for key, arr in g["data"].items():
        sp, prop = key.split("/")
        np.testing.assert_allclose(_concat(chunks, sp, prop), np.array(arr), rtol=0, atol=2e-5)


READ_CASES = {
    # kind: (species map, tolerance against the walk in Angstrom)
    "extxyz": (None, 5e-6),  # 6 decimals, then float32
    "gro": (None, 5e-3),  # 3 decimals in nm
    "gro-no-velocities": (None, 5e-3),
    "trr-single": ("map", 1e-5),  # float32 nm
    "trr-double": ("map", 1e-12),
    "trr-positions-only": (None, 1e-5),
    "dcd-little-endian": ("map", 1e-5),  # float32 Angstrom
    "dcd-big-endian": ("map", 1e-5),
}


@pytest.mark.parametrize("kind", READ_CASES)
def test_reader_matches_jax_reader(tmp_path, water, kind):
    """The same water file through both readers: equal metadata and, chunk by
    chunk, identical arrays; positions within the format's precision of the
    walk."""
    species_map, tol = READ_CASES[kind]
    species = tw.species_rows(water["n_mol"]) if species_map else None
    path = _write(kind, tmp_path / f"w.{kind[:3]}", water)
    ours, ref = _readers(kind, path, species)
    chunks = _assert_same_reading(ours, ref)
    meta = ours.metadata
    assert meta.n_configurations == 12
    np.testing.assert_allclose(meta.box_l, [BOX] * 3, rtol=1e-6)
    if species is None and kind.startswith("trr"):
        np.testing.assert_allclose(_concat(chunks, "X", "Positions"), water["wrapped"], rtol=0, atol=tol)
        return
    rows = tw.species_rows(water["n_mol"])
    for sp in ("O", "H"):
        np.testing.assert_allclose(
            _concat(chunks, sp, "Positions"), water["wrapped"][:, rows[sp]], rtol=0, atol=tol, err_msg=sp
        )
    if kind in ("gro", "trr-single", "trr-double"):
        v = _concat(chunks, "O", "Velocities")
        np.testing.assert_allclose(v, water["velocities"][:, rows["O"]] / 0.02, rtol=0,
                                   atol=1e-3 if kind == "gro" else 1e-4)
    if kind.startswith("trr-") and kind != "trr-positions-only":
        f = _concat(chunks, "H", "Forces")
        np.testing.assert_allclose(f, water["unwrapped"][:, rows["H"]] * 3.0, rtol=1e-6 if kind == "trr-single" else 1e-12)


def test_gro_sample_rate_from_titles_and_argument(tmp_path, water):
    """``t=`` titles 0.02 ps apart round to no sample rate in both packages;
    an explicit ``sample_rate`` wins in both."""
    path = _write("gro", tmp_path / "w.gro", water)
    assert file_io.GROFile(path).metadata.sample_rate is None
    assert jax_io.GROFile(path).metadata.sample_rate is None
    assert file_io.GROFile(path, sample_rate=10).metadata.sample_rate == 10


def test_dcd_trusts_file_size_over_header(tmp_path, water):
    path = _write("dcd-little-endian", tmp_path / "w.dcd", water)
    raw = bytearray(path.read_bytes())
    raw[8:12] = struct.pack("<i", 999)  # icntrl[0], the header's frame count
    path.write_bytes(bytes(raw))
    assert file_io.DCDFile(path).metadata.n_configurations == 12
    assert jax_io.DCDFile(path).metadata.n_configurations == 12


# ------------------------------------------------------------------- errors
def _trr_bad_magic(path, w):
    path.write_bytes(struct.pack(">i", 1234) + b"\0" * 64)


def _trr_triclinic(path, w):
    tri = [[BOX, 0.0, 0.0], [3.0, BOX, 0.0], [0.0, 1.0, BOX]]
    tw.write_trr(path, BOX, x=w["wrapped"], box_matrix=tri)


ERROR_CASES = {
    "trr-bad-magic": ("TRRFile", _trr_bad_magic, None, "magic"),
    "trr-triclinic": ("TRRFile", _trr_triclinic, None, "triclinic"),
    "dcd-fixed-atoms": ("DCDFile", lambda p, w: tw.write_dcd(p, w["wrapped"], BOX, fixed_atoms=2),
                        None, "fixed-atom"),
    "dcd-4d": ("DCDFile", lambda p, w: tw.write_dcd(p, w["wrapped"], BOX, flag_4d=1), None, "4D"),
    "dcd-species-out-of-range": ("DCDFile", lambda p, w: tw.write_dcd(p, w["wrapped"], BOX),
                                 {"O": [0, 1, 200]}, "outside"),
    "dcd-species-overlap": ("DCDFile", lambda p, w: tw.write_dcd(p, w["wrapped"], BOX),
                            {"O": list(range(0, 50)), "H": list(range(40, 81))}, "overlap"),
    "dcd-species-incomplete": ("DCDFile", lambda p, w: tw.write_dcd(p, w["wrapped"], BOX),
                               {"O": [0, 1]}, "every atom"),
    "trr-species-out-of-range": ("TRRFile", lambda p, w: tw.write_trr(p, BOX, x=w["wrapped"]),
                                 {"O": [-1, 0]}, "outside"),
}


@pytest.mark.parametrize("case", ERROR_CASES)
def test_reader_errors_match_jax(tmp_path, water, case):
    name, write, species, match = ERROR_CASES[case]
    path = tmp_path / f"bad.{name[:3].lower()}"
    write(path, water)
    kw = {} if species is None else {"species": species}
    for package in (file_io, jax_io):
        with pytest.raises(ValueError, match=match):
            getattr(package, name)(path, **kw).metadata


# ---------------------------------------------------- dispatch and ingestion
SUFFIXES = {".extxyz": "extxyz", ".xyz": "extxyz", ".gro": "gro", ".dcd": "dcd-little-endian",
            ".trr": "trr-single"}


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_suffix_dispatch_and_ingestion(tmp_path, water, suffix):
    """A path with each suffix picks the JAX package's reader class and
    ingests through ``add_experiment``: the stored arrays are the reader's
    (float32) and the metadata is the JAX package's."""
    import lammps_analysis_tpu as latpu
    import lammps_analysis_tpu_torch as lt

    path = _write(SUFFIXES[suffix], tmp_path / f"w{suffix}", water)
    reader = _processor_for_path(path)
    assert type(reader).__name__ == type(jax_processor_for_path(path)).__name__
    chunks = list(reader.get_configurations_generator())
    exps = {}
    for name, pkg in (("torch", lt), ("jax", latpu)):
        project = pkg.Project(name="p", storage_path=tmp_path / name)
        exps[name] = project.add_experiment(
            "e", timestep=0.002, units="metal", simulation_data=str(path)
        )
    ours, ref = exps["torch"], exps["jax"]
    assert ours.number_of_configurations == ref.number_of_configurations == 12
    assert {k: v.n_particles for k, v in ours.species.items()} == {
        k: v.n_particles for k, v in ref.species.items()
    }
    assert ours.box_array == ref.box_array
    assert ours.sample_rate == ref.sample_rate
    for sp in ours.species:
        stored = ours.store.load([f"{sp}/Positions"])[f"{sp}/Positions"]
        assert stored.dtype == np.float32
        np.testing.assert_array_equal(stored, _concat(chunks, sp, "Positions").astype(np.float32))


def test_unknown_suffix_raises(tmp_path):
    with pytest.raises(ValueError, match="Cannot infer a reader"):
        _processor_for_path(tmp_path / "w.pdb")


def test_chemfiles_absent_raises_import_error(tmp_path):
    """chemfiles is in neither environment: constructing the reader raises
    the JAX package's ImportError; the alias module is the same class."""
    from lammps_analysis_tpu_torch.file_io import chemfiles_io, chemfiles_read

    assert not chemfiles_io.CHEMFILES_AVAILABLE
    assert chemfiles_read.ChemfilesRead is chemfiles_io.ChemfilesRead is file_io.ChemfilesRead
    path = tmp_path / "w.trr"
    with pytest.raises(ImportError) as ours:
        file_io.ChemfilesRead(path)
    with pytest.raises(ImportError) as ref:
        jax_io.ChemfilesRead(path)
    assert str(ours.value) == str(ref.value)
