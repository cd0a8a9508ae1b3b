"""Device dispatch of the RDF and ADF histograms.

Counterpart of ``sharded_rdf_histogram``, ``_AdfPlan``, ``AdfBatchRunner`` and
``sharded_adf_histogram`` in ``lammps_analysis_tpu/parallel/sharded_ops.py``,
for one GPU. The JAX package chunks frames to fit the TPU kernels' VMEM and
shards them over a mesh; the CUDA kernels take any frame count, so the calls
go straight to the kernel wrappers. Multi-GPU frame sharding is a later
slice: a mesh raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import adf_kernel, rdf_kernel


def _single_device(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"multi-device {what} is not ported yet (the multi-GPU slice); "
            "call without a mesh to run on one device"
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
    """``(n_pairs, n_bins)`` int64 counts of one frame batch, on its device."""
    _single_device(mesh, "RDF")
    return rdf_kernel.rdf_histogram(
        positions, species_id, box, cutoff, n_bins, n_species
    )


class AdfPlan:
    """Neighbor-list width K for the ADF, and its escalation on saturation.

    K starts from the density: the expected in-cutoff count plus six
    standard deviations plus 16 (``sharded_ops.py:274-276`` of the JAX
    package; per-center counts are Poisson-like), rounded up to 8 and
    clipped to [24, 512] and to the atom count. The extract reports true
    counts, so a saturated run (largest count above K) escalates to at
    least that count, and one retry always suffices.
    """

    def __init__(self, n_avail: int, box, cutoff: float):
        volume = float(np.prod(np.asarray(box, dtype=np.float64)))
        rho = n_avail / max(volume, 1e-30)
        self.expected = rho * 4.0 / 3.0 * np.pi * float(cutoff) ** 3
        k_tight = self.expected + 6.0 * np.sqrt(max(self.expected, 1.0)) + 16.0
        k_n = int(np.clip(-(-int(np.ceil(k_tight)) // 8) * 8, 24, 512))
        self.n_avail = n_avail
        self.k_n = max(1, min(k_n, n_avail))

    def escalate(self, max_count: int) -> bool:
        """Widen K after a saturated run; False when the run was exact."""
        if max_count <= self.k_n or self.k_n >= self.n_avail:
            return False
        wanted = max(2 * self.k_n, -(-max_count // 8) * 8)
        self.k_n = min(wanted, self.n_avail)
        return True


class AdfBatchRunner:
    """Streamed ADF batches with one device sync for the whole run.

    ``feed`` dispatches one normalisation batch of frames (the neighbor
    extract, then the angle histogram, per launch chunk of frames) and adds
    its histogram and its largest neighbor count into device tensors; it
    never waits for the device. ``finalize`` syncs once: if some center had
    more neighbors than K, the plan has escalated, the sums are reset and it
    returns ``None``, and the caller feeds every batch again.

    ``normalize_per_batch`` (the bin width) divides each batch's histogram
    by its own ``total * bin_width`` per triple on the device: the
    reference's per-batch density normalisation (``sharded_ops.py:820-822``
    of the JAX package), which makes the batch split part of the result.
    """

    #: bytes of neighbor lists one launch may hold (rx, ry, rz, d, sid)
    LIST_BYTES = 2**30

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
        _single_device(mesh, "ADF")
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
        self._max_count = None

    def feed(self, positions: torch.Tensor) -> None:
        """Dispatch one frame batch; no host synchronisation."""
        n_frames, n_atoms, _ = positions.shape
        k_n = self.plan.k_n
        chunk = max(1, self.LIST_BYTES // max(n_atoms * k_n * 20, 1))
        hist = None
        for f0 in range(0, n_frames, chunk):
            *lists, counts = adf_kernel.neighbor_extract(
                positions[f0 : f0 + chunk], self.species_id, self.box,
                self.cutoff, k_n, self.n_species,
            )
            h = adf_kernel.adf_pairs_histogram(
                *lists, counts, self.species_id, self.n_bins, self.n_species,
                self.norm_power,
            ).sum(0)
            hist = h if hist is None else hist + h
            mc = counts.max()
            self._max_count = (
                mc if self._max_count is None else torch.maximum(self._max_count, mc)
            )
        if self.bin_width is not None:
            total = hist.sum(1, keepdim=True)
            hist = torch.where(total > 0, hist / (total * self.bin_width), 0.0)
        self._hist = hist if self._hist is None else self._hist + hist

    def finalize(self) -> torch.Tensor | None:
        """The accumulated ``(n_triples, n_bins)`` float32 histogram on the
        device, or ``None`` after a saturated run (feed every batch again)."""
        if self._hist is None:
            raise ValueError("finalize() before any feed()")
        if self.plan.escalate(int(self._max_count)):
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
    until no neighbor list saturates."""
    runner = AdfBatchRunner(
        positions.shape[1], species_id, box, cutoff, n_bins, n_species,
        norm_power=norm_power, mesh=mesh,
    )
    while True:
        runner.feed(positions)
        hist = runner.finalize()
        if hist is not None:
            return hist
