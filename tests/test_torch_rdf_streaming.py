"""The port's RDF over two species streamed in several frame batches: the
int64 counts the batches add up to, and the g(r) made from them, equal those
of one batch bit for bit, and each batch dispatched counts one
``rdf.batches``. The planner's budget override sets the batches."""

import numpy as np
import pytest
import torch

import lammps_analysis_tpu_torch as lt
from lammps_analysis_tpu_torch.calculators import radial_distribution_function
from lammps_analysis_tpu_torch.database import SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata
from lammps_analysis_tpu_torch.database.properties import PropertyInfo
from lammps_analysis_tpu_torch.file_io import ScriptInput
from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
from lammps_analysis_tpu_torch.parallel.sharded_ops import sharded_rdf_histogram
from lammps_analysis_tpu_torch.utils import profiling
from lammps_analysis_tpu_torch.utils.config import config

torch.set_num_threads(1)

#: unequal species, so the pair rows differ; the ions are padded to 104
N_NA, N_CL, N_FRAMES, BOX = 60, 43, 26, 10.0
#: bytes of one frame in the RDF's batch model: 128-atom tiles of the padded
#: atoms at 24 bytes an atom pair, and 12 bytes an atom
FRAME_BYTES = 128 * 104 * 24 + 104 * 12
ARGS = dict(cutoff=4.9, number_of_bins=97, number_of_configurations=N_FRAMES)


@pytest.fixture()
def experiment(tmp_path):
    old = config.device
    config.device = "cpu"
    rng = np.random.default_rng(29)
    prop = PropertyInfo("Positions", 3)
    species = [SpeciesInfo("Na", N_NA, [prop]), SpeciesInfo("Cl", N_CL, [prop])]
    chunk = TrajectoryChunkData(species, N_FRAMES)
    pos = rng.uniform(0, BOX, size=(N_FRAMES, N_NA + N_CL, 3))
    chunk.add_data(pos[:, :N_NA], 0, "Na", "Positions")
    chunk.add_data(pos[:, N_NA:], 0, "Cl", "Positions")
    meta = TrajectoryMetadata(n_configurations=N_FRAMES, species_list=species,
                              box_l=[BOX] * 3, sample_rate=1)
    project = lt.Project(name="stream", storage_path=tmp_path)
    yield project.add_experiment("e", timestep=0.002, units="metal",
                                 simulation_data=ScriptInput(chunk, meta, "d"))
    config.device = old


def _counts(exp, budget, monkeypatch):
    """A forced call under ``budget``: its batches, the sum of the batches'
    int64 counts and the answer."""
    exp.planner = BatchPlanner(memory_budget_bytes=budget)
    batches = []

    def kept(*args, **kwargs):
        batches.append(sharded_rdf_histogram(*args, **kwargs))
        return batches[-1]

    monkeypatch.setattr(radial_distribution_function, "sharded_rdf_histogram", kept)
    before = profiling.counters.copy()
    answer = exp.run.RadialDistributionFunction(force=True, plot=False, **ARGS)
    delta = profiling.counters - before
    assert delta["rdf.batches"] == delta["k1.plain"] == len(batches)
    assert delta["k1.pair_rows"] == 0  # the plain version launches nothing
    assert all(h.dtype == torch.int64 and h.shape == (3, ARGS["number_of_bins"]) for h in batches)
    return len(batches), torch.stack(batches).sum(0), answer.data_dict


@pytest.mark.parametrize("frames_a_batch, n_batches", [(9, 3), (4, 7)])
def test_two_species_streamed_equal_one_batch(experiment, monkeypatch, frames_a_batch, n_batches):
    one = _counts(experiment, None, monkeypatch)
    # the RDF's batch is a quarter of the planner's budget
    streamed = _counts(experiment, 4 * frames_a_batch * FRAME_BYTES, monkeypatch)
    assert (one[0], streamed[0]) == (1, n_batches)
    assert int(one[1].sum()) > 0 and all(int(row.sum()) > 0 for row in one[1])
    assert torch.equal(streamed[1], one[1])
    assert set(one[2]) == {"Na_Na", "Na_Cl", "Cl_Cl"}
    assert streamed[2] == one[2]
