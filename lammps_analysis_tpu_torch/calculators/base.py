"""Calculator orchestration: cache -> compute -> persist.

Counterpart of ``lammps_analysis_tpu/calculators/base.py`` for this slice.
The orchestration contract is the JAX package's: a calculator invocation
first probes the results DB for a computation with identical canonical args
and experiment version; a miss runs the analysis and persists per-subject
result series; the return value is a :class:`Computation` (or
``{experiment: Computation}`` when invoked from a project).

``TrajectoryCalculator`` carries atom selections, the concatenated-positions
loader of the structural calculators, the dependency check that runs the
transformation producing a missing property (per species, or the system
series under ``Observables`` for ``system_property`` calculators), and the
windowed stream of the correlation calculators: window-aligned frame slabs,
split along the atom axis when one window of all atoms exceeds the memory
budget, loaded in float32 and copied to ``config.device`` one slab ahead. A
system series streams as ``Observables/<property>`` with one particle; the
distinct diffusion pair streams two species' slabs together
(``_stream_properties_multi``). With ``config.fuse_streaming`` an
``Unwrapped_Positions`` stream whose dataset is not materialised is unwrapped
on the fly from the wrapped positions (``_stream_unwrapped_fused``).

``plot=True`` (the default, as in the JAX package) writes each computation's
plots under the experiment's ``figures/``: a self-contained HTML
(``visualizer/html_plots.py``) first, then a PNG where matplotlib imports.
The JAX package writes the PNG first, so on a machine without matplotlib it
writes neither. A failing plot is logged and never fails the analysis.

In a process group every rank runs the calculator (the sharded ops split the
work over the default mesh); rank 0 alone decides the cache lookup, runs the
dependency check's transformations and stores the result, and every rank
returns the same Computation (``parallel/multihost.py::rank_zero``); rank 0
alone writes the plots.

Each experiment's part of a call runs in the span ``call``, which gives the
spans under it their call id, the dependency check in ``deps`` and the batch
and slab plans in ``calc.plan`` (``utils/profiling.py``).
"""

from __future__ import annotations

import abc
import dataclasses
import logging
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..database.properties import mdsuite_properties as mp
from ..database.results_db import Computation
from ..database.trajectory_store import join_path
from ..memory.planner import BatchPlan
from ..parallel.multihost import rank_zero
from ..pipeline.prefetch import prefetch_to_device
from ..transformations.coordinate_transforms import CoordinateUnwrapper
from ..transformations.registry import transformation_for_property
from ..utils import profiling
from ..utils.config import config, get_device
from ..utils.constants import DatasetKeys
from ..utils.progress import progress_iter
from ..visualizer.html_plots import write_html_plot
from ..visualizer.plots import have_matplotlib, plot_series_results

log = logging.getLogger(__name__)


def window_aligned_slabs(
    n_frames: int, slab: int, data_range: int, correlation_time: int
) -> List[tuple]:
    """Window-aligned (start, stop) slabs covering every sliding window.

    The windows of a whole-array run start at ``0, ct, 2*ct, ...`` while
    ``start + data_range <= n_frames``. Each slab begins on a window start
    and is long enough for at least one window, so iterating windows
    slab-relatively (``0, ct, ...`` within each slab) enumerates exactly
    the global window set, each window once (property-tested).
    """
    slab = max(slab, data_range)
    slabs = []
    start = 0
    while start + data_range <= n_frames:
        stop = min(start + slab, n_frames)
        slabs.append((start, stop))
        if stop >= n_frames:
            break
        n_windows = (stop - start - data_range) // correlation_time + 1
        start = start + n_windows * correlation_time
    return slabs


@dataclasses.dataclass(frozen=True)
class StreamSlabInfo:
    """Provenance of one streamed slab (atom-minibatch aware).

    ``group``/``n_groups`` describe the atom-axis minibatch the slab belongs
    to: when one ``data_range``-frame window of all atoms exceeds the memory
    budget, the stream splits the (selected) atoms into ``n_groups``
    contiguous groups and re-streams the frame slabs per group (reference
    atom-wise minibatching, ``memory_manager.py:257-340``).
    """

    start: int  # global frame start of the slab
    stop: int  # global frame stop (exclusive)
    slab_index: int  # position in the slab sequence (same for every group)
    n_slabs: int
    group: int  # atom-group index
    n_groups: int


class Calculator(abc.ABC):
    """Base orchestration for all calculators."""

    #: per-subject series outputs (e.g. x, y)
    result_series_keys: List[str] = []

    def __init__(self, experiment=None, experiments=None, plot: bool = True):
        self.experiment = experiment
        self.experiments = experiments or ([experiment] if experiment else [])
        # project-bound call (experiment=None): ALWAYS return a dict keyed
        # by experiment name, even for one active experiment
        self._return_dict = experiment is None
        self.plot = plot
        self.args: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return type(self).__name__

    # ------------------------------------------------------------ entry point
    def __call__(self, **kwargs) -> Union[Computation, Dict[str, Computation]]:
        plot = kwargs.pop("plot", self.plot)
        # force=True invalidates the cached computation with these exact
        # args and recomputes
        force = kwargs.pop("force", False)
        results: Dict[str, Computation] = {}
        for exp in self.experiments:
            with profiling.annotate("call"):
                self.experiment = exp
                self.args = self.prepare_args(**kwargs)
                cache_args = dict(self.args)
                if force:
                    exp.db.delete_computations(exp.name, self.name, cache_args)
                # rank 0 decides hit or miss for every rank
                comp = rank_zero(exp.db.find_computation)(
                    exp.name, self.name, cache_args, exp.version
                )
                if comp is None:
                    log.info("%s: computing on %s", self.name, exp.name)
                    data = self.run_calculator()
                    comp = exp.db.store_computation(
                        exp.name, self.name, cache_args, exp.version, data
                    )
                else:
                    log.info("%s: cache hit on %s", self.name, exp.name)
                if plot:
                    rank_zero(self._plot_quietly)(comp)
                results[exp.name] = comp
        if self._return_dict or len(results) > 1:
            return results
        return next(iter(results.values()))

    # ---------------------------------------------------------------- plugin
    @abc.abstractmethod
    def prepare_args(self, **kwargs) -> Dict[str, Any]:
        """Parse user kwargs into the canonical (JSON-serialisable) arg dict,
        which is the cache key."""

    @abc.abstractmethod
    def run_calculator(self) -> Dict[str, dict]:
        """Run the analysis; return ``{subject_key: result_dict}``."""

    def _plot_quietly(self, computation: Computation) -> None:
        try:
            self.plot_results(computation)
        except Exception as err:  # plotting must never kill an analysis
            log.warning("%s: plotting failed: %s", self.name, err)

    def plot_results(self, computation: Computation) -> None:
        """Default plots of ``result_series_keys`` (x, then y) per subject:
        ``figures/<name>.html``, then ``figures/<name>.png`` where
        matplotlib imports (the reference writes bokeh HTML per analysis,
        ``visualizer/d2_data_visualization.py:36-140``)."""
        figures = self.experiment.path / "figures"
        write_html_plot(computation, self.result_series_keys, out_dir=figures, title=self.name)
        if have_matplotlib():
            plot_series_results(computation, self.result_series_keys, out_dir=figures,
                                title=self.name)
        else:
            log.info("%s: matplotlib does not import; %s.png not written", self.name, self.name)


class TrajectoryCalculator(Calculator):
    """Adds trajectory streaming + dependency resolution to Calculator."""

    #: property this calculator streams (PropertyInfo)
    loaded_property = None
    #: True -> ``loaded_property`` is a system series under ``Observables``
    system_property = False
    #: memory cost model (same spec format as the reference)
    scale_function: dict = {"linear": {"scale_factor": 1}}
    #: bytes one streamed slab may hold: the windowed kernels want many
    #: moderate slabs, the JAX package's cap
    MAX_SLAB_BYTES = 1 << 29

    # ------------------------------------------------------- tau/window setup
    def _handle_tau_values(self) -> np.ndarray:
        """Normalise ``tau_values`` (int / list / slice) and return times.

        Port of ``trajectory_calculator.py:196-228``; also sets
        ``self.data_resolution`` and may adjust ``args['data_range']``.
        """
        tau = self.args.get("tau_values", None)
        data_range = self.args["data_range"]
        if isinstance(tau, dict) and "slice" in tau:
            tau = slice(*tau["slice"])  # canonical encoded form
        if isinstance(tau, int):
            self.data_resolution = tau
            tau = np.linspace(0, data_range - 1, tau, dtype=int)
        elif isinstance(tau, (list, np.ndarray)):
            tau = np.asarray(tau, dtype=int)
            self.data_resolution = len(tau)
            self.args["data_range"] = int(tau[-1] + 1)
        elif tau is None or isinstance(tau, slice):
            full = np.arange(data_range, dtype=int)
            tau = full[tau] if isinstance(tau, slice) else full
            self.data_resolution = len(tau)
        else:
            raise TypeError(f"Unsupported tau_values {tau!r}")
        self.tau_values = tau
        times = (
            tau
            * self.experiment.time_step
            * self.experiment.sample_rate
        )
        return np.asarray(times, dtype=float)

    @staticmethod
    def encode_tau_values(tau) -> object:
        """Canonical JSON-able form of ``tau_values`` (cache-key safe).

        Accepts None / int (sub-sample count) / list / ndarray of lag
        indices / slice. The encoded form round-trips through
        :meth:`_handle_tau_values`.
        """
        if tau is None:
            return None
        if isinstance(tau, slice):
            if tau == slice(None):
                return None
            return {"slice": [tau.start, tau.stop, tau.step]}
        if isinstance(tau, (int, np.integer)):
            return int(tau)
        return [int(t) for t in tau]

    # ------------------------------------------------------------ dependencies
    @rank_zero
    def _run_dependency_check(self, species: Optional[List[str]] = None):
        """Run the transformation that produces a missing or incomplete
        loaded property (port of ``trajectory_calculator.py:117-194``): per
        species, or once for a system series (JAX package
        ``calculators/base.py:240-251``)."""
        with profiling.annotate("deps"):
            if self.loaded_property is None:
                return
            prop = self.loaded_property.name
            exp = self.experiment
            complete = self._complete

            if self.system_property:
                if complete(join_path(DatasetKeys.OBSERVABLES, prop)):
                    return
                producer = transformation_for_property(prop)
                if producer is None:
                    raise ValueError(
                        f"{self.name}: required property {prop} not in store and "
                        "no transformation produces it."
                    )
                producer.run_transformation(exp)
                return
            for sp in species or self.args.get("species", []):
                if complete(join_path(sp, prop)):
                    continue
                if self._fusible_unwrap(sp):
                    # config.fuse_streaming: the stream unwraps the wrapped
                    # positions on the fly, nothing is materialised
                    continue
                producer = transformation_for_property(
                    prop, experiment=exp, species=sp
                )
                if producer is None:
                    raise ValueError(
                        f"{self.name}: required property {prop} missing for "
                        f"species {sp} and no transformation produces it."
                    )
                producer.run_transformation(exp, [sp])

    def _complete(self, path: str) -> bool:
        """``path`` is stored and covers every configuration (appended data
        must re-trigger the producing transformation)."""
        store = self.experiment.store
        return (
            store.check_existence(path)
            and store.get_cursor(path) >= self.experiment.number_of_configurations
        )

    # ---------------------------------------------------------- atom selection
    @staticmethod
    def encode_atom_selection(sel) -> object:
        """Canonical JSON-able form of an atom selection (cache-key safe).

        Accepts None / slice / list of indices / {species: list}.
        """
        if sel is None:
            return None
        if isinstance(sel, slice):
            if sel == slice(None):
                return None
            return {"slice": [sel.start, sel.stop, sel.step]}
        if isinstance(sel, dict):
            return {k: [int(i) for i in v] for k, v in sel.items()}
        return [int(i) for i in sel]

    @staticmethod
    def resolve_atom_selection(encoded, species: str):
        """Encoded selection -> store-level atoms argument for one species."""
        if encoded is None:
            return None
        if isinstance(encoded, dict):
            if "slice" in encoded and isinstance(encoded["slice"], list):
                return slice(*encoded["slice"])
            per_species = encoded.get(species)
            # dtype pinned: an EMPTY list would default to float64 and
            # break fancy indexing
            return (
                np.asarray(per_species, dtype=np.int64)
                if per_species is not None
                else None
            )
        return np.asarray(encoded, dtype=np.int64)

    @staticmethod
    def _count_selected(sel, n_full: int) -> int:
        """Atoms a resolved selection (None / slice / index array) keeps of
        ``n_full``."""
        if sel is None:
            return n_full
        if isinstance(sel, slice):
            return len(range(*sel.indices(n_full)))
        return len(sel)

    def selected_counts(self, species) -> List[int]:
        """Per-species particle counts after applying ``args['atom_selection']``."""
        return [
            self._count_selected(
                self.resolve_atom_selection(self.args.get("atom_selection"), sp),
                self.experiment.entity(sp).n_particles,
            )
            for sp in species
        ]

    # --------------------------------------------------------------- loading
    def load_concat_positions(self, species, frame_idx, n_pad, dtype):
        """Sampled frames for several species, concatenated + zero-padded.

        Loads the calculator's ``loaded_property`` for each species at the
        given frame indices (honoring atom selections), concatenates along
        the atom axis and zero-pads to ``n_pad`` atoms.
        """
        exp = self.experiment
        parts = []
        for sp in species:
            path = join_path(sp, self.loaded_property.name)
            sel = self.resolve_atom_selection(
                self.args.get("atom_selection"), sp
            )
            parts.append(
                exp.store.load(
                    [path], frames=np.asarray(frame_idx), atoms=sel, dtype=dtype
                )[path]
            )
        pos = np.concatenate(parts, axis=1)
        if pos.shape[1] < n_pad:
            pad = np.zeros(
                (pos.shape[0], n_pad - pos.shape[1], 3), dtype=pos.dtype
            )
            pos = np.concatenate([pos, pad], axis=1)
        return pos

    # --------------------------------------------------------------- planning
    def _plan_for(self, paths: List[str], data_range: Optional[int] = None) -> BatchPlan:
        with profiling.annotate("calc.plan"):
            n_frames = self.experiment.number_of_configurations
            bytes_per_frame = 0
            for p in paths:
                _, n_atoms, n_dims = self.experiment.store.get_data_size(p)
                bytes_per_frame += n_atoms * n_dims * 8
            return self.experiment.planner.plan(
                n_frames=n_frames,
                bytes_per_frame=bytes_per_frame,
                scale_function=self.scale_function,
                data_range=data_range,
            )

    # --------------------------------------------------------------- streaming
    def _window_slab_plan(
        self, path: str, data_range: int, correlation_time: int,
        max_slab_bytes: Optional[int] = None,
    ) -> list:
        """Window-aligned (start, stop) slabs covering every sliding window.

        Consecutive slabs overlap by ``data_range - correlation_time`` frames
        so every window (stride ``correlation_time``) is seen exactly once
        across slab boundaries. ``max_slab_bytes`` additionally caps the slab
        size (at a floor of two windows).
        """
        plan = self._plan_for([path], data_range=data_range)
        slab = plan.frame_batch
        if max_slab_bytes is not None:
            _, n_atoms, n_dims = self.experiment.store.get_data_size(path)
            per_frame = max(n_atoms * n_dims * 4, 1)
            slab = max(min(slab, max_slab_bytes // per_frame), 2 * data_range)
        return window_aligned_slabs(
            plan.total_frames, slab, data_range, correlation_time
        )

    def _window_stream_plan(
        self,
        path: str,
        data_range: int,
        correlation_time: int,
        max_slab_bytes: Optional[int] = None,
        n_selected: Optional[int] = None,
    ) -> tuple:
        """``(slabs, n_groups)``: frame slabs plus an atom-axis split.

        When one full-width ``data_range``-frame window fits the budget
        (``plan.raw_frame_batch >= data_range``) this is
        :meth:`_window_slab_plan` with ``n_groups = 1``. Otherwise the
        reference's graceful degradation applies (``memory_manager.py:
        257-340``): the (selected) atom axis is split into ``n_groups``
        minibatches sized so one window of one group fits, and the frame
        slabs are re-sized to the reduced width. ``n_selected`` is the
        post-``atom_selection`` atom count.
        """
        plan = self._plan_for([path], data_range=data_range)
        _, n_atoms, n_dims = self.experiment.store.get_data_size(path)
        n_sel = int(n_atoms if n_selected is None else n_selected)
        raw = plan.raw_frame_batch or plan.frame_batch
        if raw >= data_range or n_sel <= 1:
            return (
                self._window_slab_plan(
                    path, data_range, correlation_time,
                    max_slab_bytes=max_slab_bytes,
                ),
                1,
            )
        planner = self.experiment.planner
        bpaf = n_dims * 8  # bytes per atom-frame (f64 planning, as _plan_for)
        m = planner.window_atoms_per_group(
            n_sel, data_range, bpaf, self.scale_function
        )
        n_groups = -(-n_sel // m)
        gplan = planner.plan(
            n_frames=plan.total_frames,
            bytes_per_frame=m * bpaf,
            scale_function=self.scale_function,
            data_range=data_range,
        )
        slab = gplan.frame_batch
        if max_slab_bytes is not None:
            per_frame = max(m * n_dims * 4, 1)
            slab = max(min(slab, max_slab_bytes // per_frame), 2 * data_range)
        log.info(
            "%s %s: one %d-frame window of %d atoms exceeds the memory "
            "budget; splitting the atom axis into %d minibatches of <= %d "
            "atoms", self.name, path, data_range, n_sel, n_groups, m,
        )
        return (
            window_aligned_slabs(
                plan.total_frames, slab, data_range, correlation_time
            ),
            n_groups,
        )

    @staticmethod
    def _atom_groups(sel, n_full: int, n_groups: int) -> list:
        """Split a resolved atom selection into contiguous index groups.

        ``n_groups == 1`` returns ``[sel]`` unchanged (None / slice / index
        array: the store reads slices cheaper than fancy indices).
        """
        if n_groups <= 1:
            return [sel]
        if sel is None:
            base = np.arange(n_full, dtype=np.int64)
        elif isinstance(sel, slice):
            base = np.arange(n_full, dtype=np.int64)[sel]
        else:
            base = np.asarray(sel, dtype=np.int64)
        return list(np.array_split(base, n_groups))

    def _fusible_unwrap(self, species: str) -> bool:
        """True when this calculator's unwrapped-positions stream is computed
        on the fly from the wrapped positions.

        Requires ``supports_fused_streaming`` on the calculator,
        ``config.fuse_streaming``, an absent or incomplete
        ``Unwrapped_Positions`` dataset (a complete one is cheaper to read)
        and complete ``Positions``.
        """
        if not getattr(self, "supports_fused_streaming", False):
            return False  # the calculator loads outside _stream_property
        if not config.fuse_streaming or self.loaded_property is None:
            return False
        if self.loaded_property.name != mp.unwrapped_positions.name:
            return False
        return not self._complete(
            join_path(species, mp.unwrapped_positions.name)
        ) and self._complete(join_path(species, mp.positions.name))

    def _stream_unwrapped_fused(self, species: str, atoms, slabs: list):
        """Stream ``Positions`` slabs and unwrap them on ``config.device``.

        The unwrap carry (the previous frame's wrapped position and image
        count) chains across the window-aligned slabs: the carry for slab
        k+1 is rebuilt from slab k's tensors at the frame just before slab
        k+1's start, as ``CoordinateUnwrapper.bootstrap_carry`` rebuilds it
        from the store, so the result equals streaming a materialised
        ``Unwrapped_Positions`` bit for bit. When ``correlation_time >
        data_range`` the slabs are disjoint; the unwrap needs every
        consecutive-frame difference, so each load runs through the next
        slab's first frame and the gap frames enter the carry without being
        yielded.
        """
        store = self.experiment.store
        pos_path = join_path(species, mp.positions.name)
        # (start, yield_stop, load_stop): load through the next slab's start
        ext = [
            (start, stop, max(stop, slabs[i + 1][0]) if i + 1 < len(slabs) else stop)
            for i, (start, stop) in enumerate(slabs)
        ]

        def load(slab):
            start, _, load_stop = slab
            return store.load(
                [pos_path], frames=slice(start, load_stop), atoms=atoms,
                dtype=np.float32,
            )[pos_path]

        unwrapper = CoordinateUnwrapper()
        box = torch.as_tensor(
            np.asarray(self.experiment.box_array, dtype=np.float32), device=get_device()
        )
        carry = None
        for i, pos in enumerate(
            progress_iter(
                prefetch_to_device(load, ext),
                desc=f"{self.name} {species} (fused unwrap)",
                total=len(ext), unit="slab",
            )
        ):
            unwrapped, _ = unwrapper.transform_batch(
                {mp.positions.name: pos, mp.box_length.name: box}, carry
            )
            start, stop, _ = ext[i]
            if i + 1 < len(ext):
                j = ext[i + 1][0] - 1 - start
                carry = (pos[j], torch.round((unwrapped[j] - pos[j]) / box))
            yield unwrapped[: stop - start]

    def _stream_properties_multi(
        self,
        species_list: List[str],
        prop_name: str,
        data_range: int,
        correlation_time: int,
        with_info: bool = False,
    ):
        """Yield ``{species: (T_slab, N, d) tensor}`` over window-aligned slabs.

        The two-species stream of the distinct diffusion pair (JAX package
        ``base.py:645-734``): each slab loads every distinct species once,
        honouring per-species ``args['atom_selection']``, and arrives on
        ``config.device`` one slab ahead as one dict. Slabs are capped at
        ``MAX_SLAB_BYTES`` divided by the number of distinct paths. An
        over-budget window splits the atom axis of every species into the
        same number of contiguous groups, in slab-major order (outer loop
        frames, inner loop atom groups), so a consumer finishes a slab's
        windows when its last group arrives: the bilinear cross terms need
        only the per-slab particle sums, which add across groups. Pass
        ``with_info=True`` for ``(dict, StreamSlabInfo)`` pairs.
        """
        store = self.experiment.store
        uniq = list(dict.fromkeys(species_list))  # each species loaded once
        paths = {sp: join_path(sp, prop_name) for sp in uniq}
        sels = {
            sp: self.resolve_atom_selection(self.args.get("atom_selection"), sp)
            for sp in uniq
        }
        n_full = {sp: store.get_data_size(paths[sp])[1] for sp in uniq}
        slabs, n_groups = self._window_stream_plan(
            paths[uniq[0]], data_range, correlation_time,
            max_slab_bytes=self.MAX_SLAB_BYTES // len(uniq),
            n_selected=sum(self._count_selected(sels[sp], n_full[sp]) for sp in uniq),
        )
        groups = {sp: self._atom_groups(sels[sp], n_full[sp], n_groups) for sp in uniq}

        def load(item):
            (start, stop), gi = item
            return {
                sp: store.load(
                    [paths[sp]], frames=slice(start, stop), atoms=groups[sp][gi],
                    dtype=np.float32,
                )[paths[sp]]
                for sp in uniq
            }

        items = [(slab, gi) for slab in slabs for gi in range(n_groups)]
        stream = progress_iter(
            prefetch_to_device(load, items),
            desc=f"{self.name} {'+'.join(species_list)}/{prop_name}",
            total=len(items), unit="slab",
        )
        for k, data in enumerate(stream):
            if with_info:
                si, gi = divmod(k, n_groups)
                yield data, StreamSlabInfo(
                    start=slabs[si][0], stop=slabs[si][1],
                    slab_index=si, n_slabs=len(slabs),
                    group=gi, n_groups=n_groups,
                )
            else:
                yield data

    def _stream_property(
        self, species: str, prop_name: str, data_range: int,
        correlation_time: int, with_info: bool = False,
    ):
        """Yield ``(T_slab, N, d)`` float32 tensors on ``config.device``.

        The store read and host-to-device copy of slab k+1 overlap the
        caller's device work on slab k (``prefetch_to_device``). Honors
        ``args['atom_selection']``. Slabs are capped at ``MAX_SLAB_BYTES``.
        With ``config.fuse_streaming`` an unwrapped-positions stream whose
        dataset is not materialised is unwrapped on the fly from the wrapped
        positions (``_stream_unwrapped_fused``).
        When one ``data_range``-frame window of all (selected) atoms exceeds
        the memory budget, the atom axis is split into contiguous minibatches
        and the slab sequence repeats per group (outer loop atoms, inner loop
        frames, the reference's ``atom_generator`` order). Windowed sums stay
        additive across groups; consumers needing per-window reconstruction
        pass ``with_info=True`` to receive ``(tensor, StreamSlabInfo)``.
        """
        with profiling.annotate("calc.plan"):
            fused = (
                prop_name == mp.unwrapped_positions.name and self._fusible_unwrap(species)
            )
            path = join_path(species, prop_name)
            # the fused stream plans on the wrapped positions (same shape)
            plan_path = join_path(species, mp.positions.name) if fused else path
            atoms = self.resolve_atom_selection(
                self.args.get("atom_selection"), species
            )
            store = self.experiment.store
            _, n_full, _ = store.get_data_size(plan_path)
            slabs, n_groups = self._window_stream_plan(
                plan_path, data_range, correlation_time,
                max_slab_bytes=self.MAX_SLAB_BYTES,
                n_selected=self._count_selected(atoms, n_full),
            )
            groups = self._atom_groups(atoms, n_full, n_groups)
        for gi, g_atoms in enumerate(groups):
            if fused:
                inner = self._stream_unwrapped_fused(species, g_atoms, slabs)
            else:

                def load(slab, _a=g_atoms):
                    start, stop = slab
                    return store.load(
                        [path], frames=slice(start, stop), atoms=_a,
                        dtype=np.float32,
                    )[path]

                inner = progress_iter(
                    prefetch_to_device(load, slabs),
                    desc=f"{self.name} {path}"
                    + (f" [atoms {gi + 1}/{n_groups}]" if n_groups > 1 else ""),
                    total=len(slabs), unit="slab",
                )
            for si, arr in enumerate(inner):
                if with_info:
                    yield arr, StreamSlabInfo(
                        start=slabs[si][0], stop=slabs[si][1],
                        slab_index=si, n_slabs=len(slabs),
                        group=gi, n_groups=n_groups,
                    )
                else:
                    yield arr
