"""A run whose timed path is broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card (on the CPU,
at a tiny size) with one fault planted in the port, of those a cell can
have: a step that returns its state unchanged, half of the batch left out
with the mean taken over the rest, and an answer altered where it is
produced; and again at each cell's own size on three seeds on the card
(``cuda``), printing each number compared beside its limit. One card runs
each cell, so no exchange between cards can be left out.

At its own size the LJ RDF does not catch half of its frames left out: its
101 frames lie 0.02 A apart and hold one g(r), so half of them read a
``g_l1`` of 2.6-3.6e-3, some 40 times the program's float32 reading and
some 500 times under the control's, which sets the limit (PERF.md, section
2). The test at the cell's size leaves that pair out; the CPU's 40 frames of
400 atoms catch it."""

import json

import pytest
import torch

from portbench import harness, spec

from conftest import tiny_cell

RDF_MODULE = "lammps_analysis_tpu_torch.calculators.radial_distribution_function"
ADF_MODULE = "lammps_analysis_tpu_torch.calculators.angular_distribution_function"
EINSTEIN_MODULE = "lammps_analysis_tpu_torch.calculators.einstein_diffusion_coefficients"


def rdf_fault(kind):
    from lammps_analysis_tpu_torch.parallel.sharded_ops import sharded_rdf_histogram

    def broken(positions, *args):
        if kind == "unchanged":  # the batch adds nothing to the counts
            return torch.zeros_like(sharded_rdf_histogram(positions[:1], *args))
        if kind == "half":  # half the frames, scaled to the whole batch
            half = max(1, positions.shape[0] // 2)
            h = sharded_rdf_histogram(positions[:half], *args)
            return torch.round(h.double() * positions.shape[0] / half).to(h.dtype)
        h = sharded_rdf_histogram(positions, *args)  # the fullest bin doubled
        h.view(-1)[h.argmax()] *= 2
        return h

    return RDF_MODULE, "sharded_rdf_histogram", broken


def adf_fault(kind):
    from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfBatchRunner

    class Broken(AdfBatchRunner):
        def feed(self, positions):
            if kind == "unchanged" and self._hist is not None:
                kept = self._hist  # the batch leaves the sum as it was
                super().feed(positions)
                self._hist = kept
            elif kind == "half":  # every other batch left out, the rest counted twice
                if self._fed % 2 == 0:
                    super().feed(positions)
                    fed = self._fed
                    super().feed(positions)
                    self._fed = fed
                else:
                    self._fed += 1
            else:
                super().feed(positions)
                if kind == "altered" and self._fed == 1:
                    self._hist.view(-1)[self._hist.argmax()] *= 2

    return ADF_MODULE, "AdfBatchRunner", Broken


def einstein_fault(kind):
    from lammps_analysis_tpu_torch.parallel.sharded_ops import sharded_windowed_msd

    def broken(x, tau, window, stride, *args):
        if kind == "unchanged":
            total, n = sharded_windowed_msd(x, tau, window, stride, *args)
            return torch.zeros_like(total), n
        if kind == "half":  # half the atoms, scaled to all of them
            half = max(1, x.shape[1] // 2)
            total, n = sharded_windowed_msd(x[:, :half], tau, window, stride, *args)
            return total * x.shape[1] / half, n
        total, n = sharded_windowed_msd(x, tau, window, stride, *args)
        total[len(total) // 2] *= 1.01  # one lag's sum 1 % off
        return total, n

    return EINSTEIN_MODULE, "sharded_windowed_msd", broken


FAULTS = {
    "lj_melt_32k.rdf": rdf_fault,
    "lj_melt_32k.adf": adf_fault,
    "lj_melt_32k.einstein": einstein_fault,
}
KINDS = ["unchanged", "half", "altered"]
#: (cell, fault) pairs that the cell's limits do not catch at its own size
NOT_CAUGHT_AT_SIZE = {("lj_melt_32k.rdf", "half")}
AT_SIZE = [(name, kind) for name in sorted(FAULTS) for kind in KINDS
           if (name, kind) not in NOT_CAUGHT_AT_SIZE]


def run(name):
    n_frames = 100 if name.endswith("einstein") else 40  # the MSD's window is 80 frames
    return harness.Run(tiny_cell(name, n_atoms=400, n_frames=n_frames), seed=12345, seconds=0.2,
                       trace=False, device="cpu").execute()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(name, kind, port_on_cpu, monkeypatch):
    assert run(name)["correct"]
    module, attr, broken = FAULTS[name](kind)
    monkeypatch.setattr(f"{module}.{attr}", broken)
    result = run(name)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize(("name", "kind"), AT_SIZE)
def test_a_broken_timed_path_is_not_correct_at_the_cells_size(name, kind, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the run is at the cell's own size")
    module, attr, broken = FAULTS[name](kind)
    monkeypatch.setattr(f"{module}.{attr}", broken)
    results = [harness.Run(spec.find_cell(name), seed=seed, seconds=1.0, trace=False).execute()
               for seed in (41, 42, 43)]
    for seed, result in zip((41, 42, 43), results):
        print(json.dumps({"cell": name, "fault": kind, "seed": seed, "checks": result["checks"]}))
    assert not any(result["correct"] for result in results)
