"""A dry run of the sharded analysis over a world of ``n`` ranks.

Counterpart of ``__graft_entry__.py::dryrun_multichip`` of the JAX package,
on the port's process group: the same tiny seeded inputs through every
sharding axis, and the same sums printed.
"""

from __future__ import annotations

import shutil
import tempfile
from typing import Optional

import numpy as np
import torch

from . import multihost


def dryrun_multichip(n_devices: int, backend: Optional[str] = None) -> str:
    """Run the sharded ops and two calculators once over ``n_devices`` ranks.

    In a process group of ``n_devices`` ranks every rank runs the body;
    otherwise ``n_devices`` processes on ``config.device`` do
    (``multihost.launch_local``, a ``file://`` rendezvous in a temporary
    directory) over ``backend``: by default NCCL with a card a rank, gloo
    on the CPU; ``backend="gloo"`` lets ranks share a card. The body covers frames over the ``data`` axis (the RDF and
    the ADF, sums and a MAX merge), particles over it (the windowed MSD and
    ACF), the 2-D ``(data, atoms)`` mesh when ``n_devices >= 4`` and even
    (K1's i-rows and K2's center stripes), and the RDF and ADF calculators
    on a ``ScriptInput`` project. Rank 0 prints the summary line, which is
    returned; any rank's failure raises.
    """
    if multihost.world_size() == n_devices:
        return _dryrun(n_devices)
    return multihost.launch_local(n_devices, _dryrun, n_devices, backend=backend)[0]


def _dryrun(n_devices: int) -> str:
    import lammps_analysis_tpu_torch as lt
    from ..database import SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata
    from ..database.properties import PropertyInfo
    from ..file_io import ScriptInput
    from ..ops.rdf import build_species_layout
    from ..utils.config import get_device
    from .mesh import make_2d_mesh, make_data_mesh, use_mesh
    from .sharded_ops import (
        sharded_adf_histogram,
        sharded_adf_histogram_2d,
        sharded_rdf_histogram,
        sharded_rdf_histogram_2d,
        sharded_windowed_acf,
        sharded_windowed_msd,
    )

    device = get_device()
    mesh = make_data_mesh()
    if mesh.size != n_devices:
        raise RuntimeError(f"requested {n_devices} ranks, the mesh has {mesh.size}")

    rng = np.random.default_rng(1)
    n_frames = 2 * n_devices  # every rank gets frames
    sid, n_pad, _, _, _ = build_species_layout([16, 16], pad_to=8)
    box = 6.0
    sid = torch.from_numpy(sid).to(device)
    pos = torch.from_numpy(
        rng.uniform(0, box, size=(n_frames, n_pad, 3)).astype(np.float32)
    ).to(device)

    with use_mesh(mesh):
        hist = sharded_rdf_histogram(pos, sid, (box,) * 3, 2.9, 64, 2)
        t, n_particles = 32, 2 * n_devices
        walk = torch.from_numpy(
            np.cumsum(rng.normal(size=(t, n_particles, 3)), axis=0).astype(np.float32)
        ).to(device)
        msd, n_windows = sharded_windowed_msd(walk, np.arange(8), 8, 4)
        vel = torch.from_numpy(
            rng.normal(size=(64, n_devices, 3)).astype(np.float32)
        ).to(device)
        acf, _ = sharded_windowed_acf(vel, 16, 8, 2**26)
        adf = sharded_adf_histogram(pos, sid, (box,) * 3, 2.0, 16, 2)
    for name, value in (("rdf", hist), ("msd", msd), ("acf", acf), ("adf", adf)):
        if not torch.isfinite(value.double()).all():
            raise RuntimeError(f"dry run: the {name} is not finite")

    hist2d_sum = adf2d_sum = float("nan")
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2d = make_2d_mesh(2, n_devices // 2)
        hist2d = sharded_rdf_histogram_2d(pos, sid, (box,) * 3, 2.9, 64, 2, mesh2d)
        if not torch.equal(hist2d, hist):
            raise RuntimeError("dry run: the 2-D RDF differs from the frame-sharded one")
        hist2d_sum = float(hist2d.sum())
        n_a2 = 128 * (n_devices // 2)
        pos_a2 = torch.from_numpy(
            rng.uniform(0, box, size=(2, n_a2, 3)).astype(np.float32)
        ).to(device)
        sid_a2 = torch.from_numpy(np.repeat(np.arange(2), n_a2 // 2).astype(np.int32)).to(device)
        adf2d = sharded_adf_histogram_2d(pos_a2, sid_a2, (box,) * 3, 2.0, 16, 2, mesh=mesh2d)
        adf2d_sum = float(adf2d.double().sum())
        if not (np.isfinite(adf2d_sum) and adf2d_sum > 0):
            raise RuntimeError(f"dry run: the 2-D ADF sums to {adf2d_sum}")

    # the framework path: store -> calculators -> Computation, under the mesh
    n_cfg, box_l = 24, 6.0
    pos_c = rng.uniform(0, box_l, size=(n_cfg, 24, 3))
    prop = PropertyInfo("Positions", 3)
    species = [SpeciesInfo("Na", 12, [prop]), SpeciesInfo("Cl", 12, [prop])]
    meta = TrajectoryMetadata(
        n_configurations=n_cfg, species_list=species, box_l=[box_l] * 3,
        sample_rate=1, temperature=300.0,
    )
    chunk = TrajectoryChunkData(species, n_cfg)
    chunk.add_data(pos_c[:, :12], 0, "Na", "Positions")
    chunk.add_data(pos_c[:, 12:], 0, "Cl", "Positions")
    root = multihost.rank_zero(tempfile.mkdtemp)(prefix="dryrun-")  # one path for all ranks
    try:
        project = lt.Project(name="dryrun", storage_path=root)
        exp = project.add_experiment(
            "e", timestep=0.1, units="si", simulation_data=ScriptInput(chunk, meta, "d"),
        )
        with use_mesh(mesh):
            rdf = exp.run.RadialDistributionFunction(
                number_of_configurations=16, cutoff=2.9, number_of_bins=40, plot=False,
            )
            adf_calc = exp.run.AngularDistributionFunction(
                number_of_configurations=12, cutoff=2.4, number_of_bins=36, plot=False,
            )
    finally:
        multihost.rank_zero(shutil.rmtree)(root, ignore_errors=True)
    calc_sum = float(sum(np.asarray(v["y"]).sum() for v in rdf.data_dict.values()))
    adf_calc_sum = float(sum(np.asarray(v["adf"]).sum() for v in adf_calc.data_dict.values()))
    if not (np.isfinite(calc_sum) and calc_sum > 0 and np.isfinite(adf_calc_sum)
            and adf_calc_sum > 0):
        raise RuntimeError(f"dry run: calculator sums {calc_sum}, {adf_calc_sum}")

    line = (
        f"dryrun_multichip OK on {n_devices} ranks: "
        f"rdf hist sum={float(hist.sum()):.0f}, "
        f"2d-mesh sum={hist2d_sum:.0f}, "
        f"adf2d stripes sum={adf2d_sum:.3f}, "
        f"msd windows={int(n_windows)}, acf[0]={float(acf[0]):.3f}, "
        f"calc rdf g(r) sum={calc_sum:.3f}, "
        f"calc adf sum={adf_calc_sum:.3f}"
    )
    if multihost.rank() == 0:
        print(line, flush=True)
    return line
