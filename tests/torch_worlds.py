"""Seeded inputs and rank bodies of ``tests/test_torch_multigpu.py``.

numpy, torch and the port only: ``multihost.launch_local`` runs these bodies
in processes of their own, which must not import jax (a test module does,
through ``conftest.py``). The test module builds the same inputs here for
the JAX package and for the port's one-process reference.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

BOX = (5.0, 5.0, 5.0)
RDF = dict(cutoff=2.4, n_bins=60)
ADF = dict(cutoff=2.0, n_bins=36)
STRIPES = dict(n_atoms=256, n_frames=4, box=8.0, cutoff=2.0, n_bins=16)
# the calculators of the world, with the arguments both packages get
CALCULATORS = {
    "RadialDistributionFunction": dict(number_of_configurations=24, cutoff=3.9, number_of_bins=80),
    "AngularDistributionFunction": dict(number_of_configurations=12, cutoff=2.4, number_of_bins=40),
    "EinsteinDiffusionCoefficients": dict(data_range=32, correlation_time=8),
    "GreenKuboDiffusionCoefficients": dict(data_range=32, correlation_time=8),
}
ADF_BUDGET = 2**30  # one planner budget for every ADF, so all split the same batches


def f32(a):
    """``a`` rounded to float32 and back: both packages see the same values."""
    return np.asarray(a, np.float32).astype(np.float64)


def system():
    """``(sid (Npad,), pos (16, Npad, 3))``: 24 + 16 atoms in a 5 A box,
    padded to 40 (``tests/test_multidevice.py``'s system)."""
    from lammps_analysis_tpu_torch.ops.rdf import build_species_layout

    rng = np.random.default_rng(42)
    counts = [24, 16]
    sid, n_pad, _, _, _ = build_species_layout(counts, pad_to=8)
    pos = np.zeros((16, n_pad, 3))
    pos[:, : sum(counts)] = rng.uniform(0, 5, size=(16, sum(counts), 3))
    return sid, f32(pos)


def saturating_system():
    """``(sid, pos (4, 200, 3))`` in a 20 A box where the last frame packs 60
    atoms into a 1.5 A ball: the density's K (24) saturates there alone."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(0, 20, size=(4, 200, 3))
    pos[3, :60] = 10.0 + rng.uniform(-0.85, 0.85, size=(60, 3))
    return np.repeat(np.arange(2), 100).astype(np.int32), f32(pos)


def stripes_system():
    """``(sid, pos)`` of the 2-D ADF case (256 atoms, 4 frames, 8 A box)."""
    c = STRIPES
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, c["box"], size=(c["n_frames"], c["n_atoms"], 3))
    return np.repeat(np.arange(2), c["n_atoms"] // 2).astype(np.int32), f32(pos)


def walks():
    """Windowed-MSD and ACF cases: ``name -> (series (T, N, 3), window,
    stride)``; 13 and 19 particles leave remainders, 3 particles leave a rank
    of a world of four without any."""
    rng = np.random.default_rng(42)
    return {
        "msd": (np.cumsum(rng.normal(size=(60, 24, 3)), axis=0), 16, 8),
        "msd remainder": (np.cumsum(rng.normal(size=(40, 13, 3)), axis=0), 8, 8),
        "msd empty rank": (np.cumsum(rng.normal(size=(40, 3, 3)), axis=0), 8, 4),
        "acf": (rng.normal(size=(60, 19, 3)), 16, 8),
        "acf empty rank": (rng.normal(size=(60, 3, 3)), 16, 8),
    }


def one_device_ops() -> dict:
    """The op world's cases on this process alone (the reference)."""
    return _ops(two_d=False)


def op_world() -> dict:
    """Rank body: every sharded op over the world's data mesh, and the 2-D
    ops over a ``(2, world / 2)`` mesh, on ``config.device``; the results
    every rank holds, the saturated ADF's passes and K, and this rank's
    plain-version calls and kernel launches."""
    return _ops(two_d=True)


def _ops(two_d: bool) -> dict:
    from lammps_analysis_tpu_torch.parallel import (
        AdfBatchRunner,
        make_2d_mesh,
        multihost,
        sharded_adf_histogram,
        sharded_adf_histogram_2d,
        sharded_rdf_histogram,
        sharded_rdf_histogram_2d,
        sharded_windowed_acf,
        sharded_windowed_msd,
    )
    from lammps_analysis_tpu_torch.utils.config import get_device
    from lammps_analysis_tpu_torch.utils.profiling import counters

    device = get_device()

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32 if a.dtype.kind == "f" else np.int32)).to(device)

    sid, pos = (tensor(a) for a in system())
    out = {}
    for label, n_frames in (("all", 16), ("remainder", 13), ("few frames", 3)):
        out[f"rdf {label}"] = sharded_rdf_histogram(pos[:n_frames], sid, BOX, RDF["cutoff"],
                                                    RDF["n_bins"], 2).cpu().numpy()
        out[f"adf {label}"] = sharded_adf_histogram(pos[:n_frames], sid, BOX, ADF["cutoff"],
                                                    ADF["n_bins"], 2).cpu().numpy()
    sat_sid, sat_pos = saturating_system()
    runner = AdfBatchRunner(200, tensor(sat_sid), (20.0,) * 3, 3.0, 36, 2)
    passes = 0
    while True:
        passes += 1
        runner.feed(tensor(sat_pos))
        hist = runner.finalize()
        if hist is not None:
            break
    out["adf saturated"] = hist.cpu().numpy()
    out["adf saturated passes, K"] = np.array([passes, runner.plan.k_n])

    def extracts():
        return counters["k2.plain"] + counters["k2.launches.binned"] + counters["k2.launches.sweep"]

    before = extracts()
    runner = AdfBatchRunner(pos.shape[1], sid, BOX, ADF["cutoff"], ADF["n_bins"], 2,
                            normalize_per_batch=3.15 / ADF["n_bins"])
    for f in range(4):  # four one-frame normalisation batches
        runner.feed(pos[f : f + 1])
    out["adf one-frame batches"] = runner.finalize().cpu().numpy()
    out["one-frame batch extracts"] = np.array([extracts() - before])
    for name, (x, window, stride) in walks().items():
        x = tensor(x)
        if name.startswith("msd"):
            out[name] = sharded_windowed_msd(x, np.arange(window), window, stride)[0].cpu().numpy()
        else:
            acf, per_window = sharded_windowed_acf(x, window, stride, 2**26)
            out[name], out[name + " per window"] = acf.cpu().numpy(), per_window.cpu().numpy()
    st_sid, st_pos = (tensor(a) for a in stripes_system())
    c = STRIPES
    box = (c["box"],) * 3
    if two_d:
        mesh = make_2d_mesh(2, multihost.world_size() // 2)
        out["rdf 2d"] = sharded_rdf_histogram_2d(pos, sid, BOX, RDF["cutoff"], RDF["n_bins"], 2,
                                                 mesh).cpu().numpy()
        out["rdf 2d routed"] = sharded_rdf_histogram(pos, sid, BOX, RDF["cutoff"], RDF["n_bins"],
                                                     2, mesh=mesh).cpu().numpy()
        out["msd 2d"] = sharded_windowed_msd(tensor(walks()["msd"][0]),
                                             np.arange(16), 16, 8, mesh=mesh)[0].cpu().numpy()
        out["adf stripes"] = sharded_adf_histogram_2d(st_pos, st_sid, box, c["cutoff"], c["n_bins"], 2,
                                                      mesh=mesh).cpu().numpy()
        out["adf stripes routed"] = sharded_adf_histogram(st_pos, st_sid, box, c["cutoff"],
                                                          c["n_bins"], 2, mesh=mesh).cpu().numpy()
    else:
        out["adf stripes"] = sharded_adf_histogram(st_pos, st_sid, box, c["cutoff"],
                                                   c["n_bins"], 2).cpu().numpy()
    out["plain calls"] = np.array([counters["k1.plain"], counters["k2.plain"]])
    out["launches"] = np.array([counters[name] for name in ("k1.launches", "k2.launches.binned",
                                                            "k2.launches.sweep", "k3.launches")])
    return out


def nacl_experiment(package: str, root, budget: int = ADF_BUDGET):
    """Experiment ``e`` of ``package`` under ``root``: 12 Na + 8 Cl, 120
    frames in an 8 A box, with positions, unwrapped positions and velocities
    (``tests/test_multidevice.py::_nacl_experiment`` plus velocities), and
    the planner budget ``budget``."""
    pkg = importlib.import_module(package)
    db = importlib.import_module(package + ".database")
    props = importlib.import_module(package + ".database.properties")
    file_io = importlib.import_module(package + ".file_io")
    planner = importlib.import_module(package + ".memory.planner")
    rng = np.random.default_rng(77)
    n_frames, box = 120, 8.0
    data = {
        "Positions": f32(rng.uniform(0, box, size=(n_frames, 20, 3))),
        "Unwrapped_Positions": f32(np.cumsum(rng.normal(scale=0.05, size=(n_frames, 20, 3)), axis=0)),
        "Velocities": f32(rng.normal(size=(n_frames, 20, 3))),
    }
    info = [props.PropertyInfo(name, 3) for name in data]
    species = [db.SpeciesInfo("Na", 12, info), db.SpeciesInfo("Cl", 8, info)]
    meta = db.TrajectoryMetadata(
        n_configurations=n_frames, species_list=species, box_l=[box] * 3,
        sample_rate=1, temperature=300.0,
    )
    chunk = db.TrajectoryChunkData(species, n_frames)
    for name, arr in data.items():
        chunk.add_data(arr[:, :12], 0, "Na", name)
        chunk.add_data(arr[:, 12:], 0, "Cl", name)
    project = pkg.Project(name="nacl", storage_path=root)
    exp = project.add_experiment(
        "e", timestep=0.1, units="si", simulation_data=file_io.ScriptInput(chunk, meta, "d"),
    )
    exp.planner = planner.BatchPlanner(memory_budget_bytes=budget)
    return exp


def walk_experiment(root):
    """The port's experiment ``w`` under ``root``: wrapped positions of a
    seeded walk (30 Na in a 6 A box, 60 frames), for an Einstein call whose
    dependency check unwraps them."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database import SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata
    from lammps_analysis_tpu_torch.database.properties import PropertyInfo
    from lammps_analysis_tpu_torch.file_io import ScriptInput

    rng = np.random.default_rng(19)
    walk = np.cumsum(rng.normal(scale=0.4, size=(60, 30, 3)), axis=0) + 3.0
    species = [SpeciesInfo("Na", 30, [PropertyInfo("Positions", 3)])]
    meta = TrajectoryMetadata(n_configurations=60, species_list=species, box_l=[6.0] * 3,
                              sample_rate=1)
    chunk = TrajectoryChunkData(species, 60)
    chunk.add_data(np.mod(walk, 6.0).astype(np.float32), 0, "Na", "Positions")
    project = lt.Project(name="walk", storage_path=root)
    return project.add_experiment("w", timestep=0.1, units="si",
                                  simulation_data=ScriptInput(chunk, meta, "d"))


def calculators(root) -> dict:
    """The four calculators on ``nacl_experiment`` under ``root``, then the
    Einstein of ``walk_experiment``: their data dicts."""
    exp = nacl_experiment("lammps_analysis_tpu_torch", root)
    out = {name: getattr(exp.run, name)(plot=False, **kw).data_dict
           for name, kw in CALCULATORS.items()}
    walk = walk_experiment(root)
    out["walk Einstein"] = walk.run.EinsteinDiffusionCoefficients(data_range=20, plot=False).data_dict
    return out


def calculator_world(root) -> dict:
    """Rank body: :func:`calculators` over the world's default mesh, with
    this rank's store writes and collectives; the same calls again (cache
    hits: no collective); the DB's rows; this rank's planner budget."""
    from lammps_analysis_tpu_torch.database.trajectory_store import TrajectoryStore
    from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
    from lammps_analysis_tpu_torch.utils.profiling import counters

    writes = []
    open_for_write = TrajectoryStore._open_for_write

    def counted(self, path):
        writes.append(path)
        return open_for_write(self, path)

    TrajectoryStore._open_for_write = counted
    try:
        first = calculators(root)
        collectives = counters["collectives"]
        again = calculators(root)
    finally:
        TrajectoryStore._open_for_write = open_for_write
    rows = [c["name"] for c in nacl_experiment("lammps_analysis_tpu_torch", root).db.list_computations("e")]
    rows += [c["name"] for c in walk_experiment(root).db.list_computations("w")]
    return dict(
        results=first, again_equal=again == first, collectives=collectives,
        collectives_again=counters["collectives"] - collectives, writes=writes, rows=rows,
        budget=BatchPlanner().budget_bytes,
    )


def failing_world():
    """Rank body: rank 1 raises at once, rank 0 waits in a collective."""
    from lammps_analysis_tpu_torch.parallel import multihost

    if multihost.rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    multihost.barrier()
