"""Multi-device dispatch of the RDF, ADF and windowed transport ops.

Counterpart of ``lammps_analysis_tpu/parallel/sharded_ops.py`` on
``torch.distributed``, one process per GPU (``multihost.py``). Each function
keeps its JAX name, runs this rank's shard of the work on the kernels
(``ops/rdf_kernel.py``, ``ops/adf_kernel.py``) or torch ops, and merges with
the collective that the JAX ``shard_map`` body uses: ``all_reduce`` SUM of
histograms and sums, MAX of the ADF's largest neighbor count. Without a
process group the default mesh is this process alone and the calls go
straight to the kernels, as on one GPU before.

Shards: every frame, particle, i-row or center goes to exactly one rank
(``mesh.data_sharding``: the remainder to the leading ranks). JAX runs a
remainder that does not divide the devices unsharded on its one controller;
with a process per rank that would count it once per rank. A rank with
nothing to do still joins every collective, with zeros. Every rank is handed
the whole batch (the calculators load it on every rank).

Gloo and CUDA tensors: in a world whose ranks share one card (backend gloo,
``multihost.initialize``), ``_all_reduce`` copies a CUDA tensor to the host
for its collective and back. That is a staging copy, not a fallback: the
kernels still run on the card.

A collective runs in the span ``collective`` and counts in ``collectives``;
the ADF runner's ``feed`` and ``finalize`` run in ``adf.feed`` and
``adf.finalize`` and count in ``adf.batches`` and ``adf.passes``
(``utils/profiling.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import adf_kernel, correlation, msd, rdf_kernel, sorting
from ..ops.adf import n_triples_for
from ..utils import profiling
from .mesh import Mesh, data_sharding, get_default_mesh


def _resolve(mesh) -> Mesh:
    """``mesh``, or the default mesh for ``None``; anything else raises."""
    if mesh is None:
        return get_default_mesh()
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh must be a parallel.mesh.Mesh (make_data_mesh, make_2d_mesh), got {type(mesh).__name__}"
        )
    return mesh


def _all_reduce(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over every rank of ``mesh`` (``t`` itself on a mesh of
    this process alone); a CUDA tensor under gloo is staged through the host."""
    if mesh.group is None:
        return t
    with profiling.annotate("collective"):
        staged = t.is_cuda and dist.get_backend(mesh.group) == "gloo"
        buf = t.cpu() if staged else t
        dist.all_reduce(buf, op=op, group=mesh.group)
        out = buf.to(t.device) if staged else buf
    profiling.count("collectives")
    return out


def _has_atoms_axis(mesh: Mesh, n_frames: int, n_atoms: int) -> bool:
    """A ``(data, atoms)`` mesh whose atoms axis does work, on JAX's
    condition for the 2-D routes (``sharded_ops.py:189-201``)."""
    return (
        mesh.shape.get("atoms", 1) > 1
        and n_frames % mesh.shape["data"] == 0
        and n_atoms % mesh.shape["atoms"] == 0
    )


def sharded_rdf_histogram(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    mesh=None,
) -> torch.Tensor:
    """``(n_pairs, n_bins)`` int64 counts of one frame batch, on its device.

    Frames split over every mesh axis and the counts sum over the ranks;
    under a ``(data, atoms)`` mesh whose axes divide the batch, the 2-D route
    (:func:`sharded_rdf_histogram_2d`)."""
    mesh = _resolve(mesh)
    n_frames, n_atoms, _ = positions.shape
    if _has_atoms_axis(mesh, n_frames, n_atoms):
        return sharded_rdf_histogram_2d(
            positions, species_id, box, cutoff, n_bins, n_species, mesh
        )
    lo, hi = data_sharding(mesh, n_frames)
    hist = rdf_kernel.rdf_histogram(
        positions[lo:hi], species_id, box, cutoff, n_bins, n_species
    )
    return _all_reduce(hist, mesh)


def sharded_rdf_histogram_2d(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    mesh: Mesh,
) -> torch.Tensor:
    """RDF over a 2-D ``(data, atoms)`` mesh.

    Frames split over ``data``, i-rows over ``atoms``: each rank counts the
    pairs (i, j > i) of its i-rows against every atom (the global triangle)
    on K1's row range, and the counts sum over both axes. Exact: every
    unordered pair is counted once. The JAX package runs XLA ops on a pair
    tensor here, which K1 replaces, and all-gathers the j side; every rank
    holds the whole batch already. The triangle makes the first stripe
    heavier than the last, as in JAX.
    """
    lo, hi = data_sharding(mesh, positions.shape[0], "data")
    rows = data_sharding(mesh, positions.shape[1], "atoms")
    hist = rdf_kernel.rdf_histogram(
        positions[lo:hi], species_id, box, cutoff, n_bins, n_species, rows=rows
    )
    return _all_reduce(hist, mesh)


class AdfPlan:
    """Neighbor-list width K for the ADF, whether the sorted route may run,
    and their escalation.

    K starts from the density: the expected in-cutoff count plus six
    standard deviations plus 16 (``sharded_ops.py:274-276`` of the JAX
    package; per-center counts are Poisson-like), rounded up to 8 and
    clipped to [24, 512] and to the atom count. The extract reports true
    counts, so a saturated run (largest count above K) escalates to at
    least that count, and one retry always suffices. ``use_sorted`` starts
    True: the extract takes the sorted route where ``extract_route`` names
    it; a run whose windows overflowed their bound turns it off, and the run
    is repeated on the sweep (JAX ``sharded_ops.py:419-425``).
    """

    def __init__(self, n_avail: int, box, cutoff: float):
        volume = float(np.prod(np.asarray(box, dtype=np.float64)))
        rho = n_avail / max(volume, 1e-30)
        self.expected = rho * 4.0 / 3.0 * np.pi * float(cutoff) ** 3
        k_tight = self.expected + 6.0 * np.sqrt(max(self.expected, 1.0)) + 16.0
        k_n = int(np.clip(-(-int(np.ceil(k_tight)) // 8) * 8, 24, 512))
        self.n_avail = n_avail
        self.k_n = max(1, min(k_n, n_avail))
        self.use_sorted = True

    def escalate(self, max_count: int, overflow: bool = False) -> bool:
        """Widen K after a saturated run, and leave the sorted route after an
        overflowed one; False when the run stands."""
        repeat = False
        if overflow and self.use_sorted:
            self.use_sorted = False
            repeat = True
        if max_count > self.k_n and self.k_n < self.n_avail:
            wanted = max(2 * self.k_n, -(-max_count // 8) * 8)
            self.k_n = min(wanted, self.n_avail)
            repeat = True
        return repeat


#: bytes of neighbor lists one launch may hold (rx, ry, rz, d, sid)
LIST_BYTES = 2**30


def _adf_frames(positions, species_id, box, cutoff, k_n, n_species, n_bins, norm_power,
                centers=None, use_sorted=False):
    """Angle histogram ``(n_triples, n_bins)`` float32 of the frames of
    ``positions`` (summed), their largest neighbor count and the sorted
    route's overflow flag (int32 scalar tensors), on the device: the
    neighbor extract, then the angle histogram, per launch chunk of frames;
    ``centers=(c0, c1)`` takes the stripe's centers only. With
    ``use_sorted``, all centers and ``extract_route`` naming it, the extract
    sorts each frame (``sort_for``'s sort, the sort's window bound) and the
    angle histogram takes each frame's sorted center species. No host
    synchronisation."""
    n_frames, n_atoms, _ = positions.shape
    c0, c1 = (0, n_atoms) if centers is None else centers
    device = positions.device
    hist = torch.zeros((n_triples_for(n_species), n_bins), dtype=torch.float32, device=device)
    max_count = torch.zeros((), dtype=torch.int32, device=device)
    overflow = torch.zeros((), dtype=torch.int32, device=device)
    if c1 == c0:
        return hist, max_count, overflow
    sort = bound = None
    if use_sorted and centers is None and adf_kernel.extract_route(box, cutoff, k_n, n_atoms) == "sorted":
        sort = adf_kernel.sort_for(n_atoms)
        bound = sorting.window_bound(sort, n_atoms, box, cutoff)
    chunk = max(1, LIST_BYTES // max((c1 - c0) * k_n * 20, 1))
    for f0 in range(0, n_frames, chunk):
        per_frame, counts, flag = adf_kernel.frame_angle_histograms(
            positions[f0 : f0 + chunk], species_id, box, cutoff, k_n, n_species, n_bins,
            norm_power, sort, bound, centers,
        )
        hist += per_frame.sum(0)
        max_count = torch.maximum(max_count, counts.max())
        if flag is not None:
            overflow = torch.maximum(overflow, flag)
    return hist, max_count, overflow


class AdfBatchRunner:
    """Streamed ADF batches with one device sync for the whole run.

    ``feed`` dispatches one normalisation batch of frames: this rank's
    frames of it (split over every mesh axis) through the neighbor extract
    and the angle histogram, then the histogram summed over the ranks; it
    never waits for the device on one GPU. ``finalize`` syncs once: the
    largest neighbor count and the sorted route's overflow flag are reduced
    (MAX) over the ranks, so every rank takes the same decision; if some
    center had more neighbors than K, or some window overflowed its bound,
    the plan has escalated (a wider K, the sweep), the sums are reset and it
    returns ``None``, and the caller feeds every batch again. The route does
    not change the lists' sets, so neither the result nor the batch split
    depends on it.

    ``normalize_per_batch`` (the bin width) divides each batch's histogram,
    summed over the ranks first, by its own ``total * bin_width`` per triple
    on the device: the reference's per-batch density normalisation
    (``sharded_ops.py:820-822`` of the JAX package), which makes the batch
    split part of the result.
    """

    def __init__(
        self,
        n_atoms: int,
        species_id: torch.Tensor,
        box,
        cutoff: float,
        n_bins: int,
        n_species: int,
        norm_power: int = 4,
        normalize_per_batch: float | None = None,
        mesh=None,
    ):
        self.mesh = _resolve(mesh)
        self.species_id = species_id
        self.box = box
        self.cutoff = cutoff
        self.n_bins = n_bins
        self.n_species = n_species
        self.norm_power = norm_power
        self.bin_width = normalize_per_batch
        self.plan = AdfPlan(n_atoms, box, cutoff)
        self._reset()

    def _reset(self) -> None:
        self._hist = None
        self._flags = None  # (largest count, overflow)
        self._fed = 0

    def feed(self, positions: torch.Tensor) -> None:
        """Dispatch one frame batch; the batches' remainder frames rotate
        over the ranks (one-frame batches go to each rank in turn)."""
        with profiling.annotate("adf.feed"):
            lo, hi = data_sharding(self.mesh, positions.shape[0], turn=self._fed)
            self._fed += 1
            hist, max_count, overflow = _adf_frames(
                positions[lo:hi], self.species_id, self.box, self.cutoff, self.plan.k_n,
                self.n_species, self.n_bins, self.norm_power, use_sorted=self.plan.use_sorted,
            )
            hist = _all_reduce(hist, self.mesh)
            if self.bin_width is not None:
                total = hist.sum(1, keepdim=True)
                hist = torch.where(total > 0, hist / (total * self.bin_width), 0.0)
            self._hist = hist if self._hist is None else self._hist + hist
            flags = torch.stack([max_count, overflow])
            self._flags = flags if self._flags is None else torch.maximum(self._flags, flags)
        profiling.count("adf.batches")

    def finalize(self) -> torch.Tensor | None:
        """The accumulated ``(n_triples, n_bins)`` float32 histogram on the
        device, or ``None`` after a saturated or overflowed run (feed every
        batch again)."""
        if self._hist is None:
            raise ValueError("finalize() before any feed()")
        with profiling.annotate("adf.finalize"):
            max_count, overflow = _all_reduce(self._flags, self.mesh, dist.ReduceOp.MAX).tolist()
        profiling.count("adf.passes")
        if self.plan.escalate(max_count, bool(overflow)):
            self._reset()
            return None
        return self._hist


def sharded_adf_histogram(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    norm_power: int = 4,
    mesh=None,
) -> torch.Tensor:
    """``(n_triples, n_bins)`` float32 weighted angle counts of one frame
    batch, on its device (not density-normalised); retries with a wider K
    until no neighbor list saturates. Frames split over every mesh axis;
    under a ``(data, atoms)`` mesh whose axes divide the batch, the center
    stripes of :func:`sharded_adf_histogram_2d` (JAX ``:631-645``)."""
    mesh = _resolve(mesh)
    if _has_atoms_axis(mesh, positions.shape[0], positions.shape[1]):
        return sharded_adf_histogram_2d(
            positions, species_id, box, cutoff, n_bins, n_species, norm_power, mesh
        )
    runner = AdfBatchRunner(
        positions.shape[1], species_id, box, cutoff, n_bins, n_species,
        norm_power=norm_power, mesh=mesh,
    )
    while True:
        runner.feed(positions)
        hist = runner.finalize()
        if hist is not None:
            return hist


def sharded_adf_histogram_2d(
    positions: torch.Tensor,
    species_id: torch.Tensor,
    box,
    cutoff: float,
    n_bins: int,
    n_species: int,
    norm_power: int = 4,
    mesh=None,
    plan: AdfPlan | None = None,
) -> torch.Tensor:
    """ADF over a 2-D ``(data, atoms)`` mesh.

    Frames split over ``data``, centers over ``atoms``: each rank extracts
    the neighbor lists of its stripe of centers against every atom (K2's
    center stripe, ``adf_kernel.neighbor_extract(..., centers=)``) and runs
    the angle histogram on them with the stripe's center species. A
    center's whole fan of angles lives on one rank, so the histograms sum
    over both axes; the largest neighbor count (MAX) drives the usual retry
    with a wider K. The stripes are by atom index, where the JAX package
    stripes the centers of a spatial sort (``pallas_adf.py:1309``): the
    histogram is the same for any partition of the centers.
    """
    mesh = _resolve(mesh)
    plan = plan or AdfPlan(positions.shape[1], box, cutoff)
    lo, hi = data_sharding(mesh, positions.shape[0], "data")
    centers = data_sharding(mesh, positions.shape[1], "atoms")
    while True:
        hist, max_count, _ = _adf_frames(
            positions[lo:hi], species_id, box, cutoff, plan.k_n, n_species, n_bins,
            norm_power, centers=centers,
        )
        hist = _all_reduce(hist, mesh)
        max_count = _all_reduce(max_count.reshape(1), mesh, dist.ReduceOp.MAX)
        if not plan.escalate(int(max_count)):
            return hist


def sharded_windowed_msd(
    x: torch.Tensor,
    tau_values,
    window: int,
    stride: int,
    mesh=None,
) -> tuple[torch.Tensor, int]:
    """``ops/msd.py::windowed_msd_sum`` with the particle axis split over
    every mesh axis: particles are independent, so the partial sums add
    (``all_reduce`` SUM); the window count is every rank's."""
    mesh = _resolve(mesh)
    lo, hi = data_sharding(mesh, x.shape[1])
    total, n_windows = msd.windowed_msd_sum(x[:, lo:hi].contiguous(), tau_values, window, stride)
    return _all_reduce(total, mesh), n_windows


def sharded_windowed_acf(
    x: torch.Tensor,
    window: int,
    stride: int,
    budget_bytes: int,
    tau=None,
    mesh=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``ops/correlation.py::windowed_acf_sum`` with the particle axis split
    over every mesh axis: the ACF sum adds over the ranks; the per-window
    particle mean is count-weighted (each rank's mean times its particle
    count, summed, over the total: JAX ``:893-905``)."""
    mesh = _resolve(mesh)
    if mesh.group is None:
        return correlation.windowed_acf_sum(x, window, stride, budget_bytes, tau=tau)
    total, n_particles, _ = x.shape
    lo, hi = data_sharding(mesh, n_particles)
    if hi > lo:
        acf, per_window = correlation.windowed_acf_sum(
            x[:, lo:hi].contiguous(), window, stride, budget_bytes, tau=tau
        )
        per_window = per_window * (hi - lo)
    else:  # no particle here (an FFT of nothing is an error): zeros
        n_windows = (total - window) // stride + 1 if total >= window else 0
        r = window if tau is None else len(tau)
        acf = torch.zeros(r, dtype=torch.float64, device=x.device)
        per_window = torch.zeros((max(n_windows, 0), r), dtype=torch.float64, device=x.device)
    acf = _all_reduce(acf, mesh)
    return acf, _all_reduce(per_window, mesh) / n_particles
