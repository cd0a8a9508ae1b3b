"""Calculator orchestration: cache -> compute -> persist.

Counterpart of ``lammps_analysis_tpu/calculators/base.py`` for this slice.
The orchestration contract is the JAX package's: a calculator invocation
first probes the results DB for a computation with identical canonical args
and experiment version; a miss runs the analysis and persists per-subject
result series; the return value is a :class:`Computation` (or
``{experiment: Computation}`` when invoked from a project).

``TrajectoryCalculator`` carries only what the RDF needs: atom selections,
the concatenated-positions loader and the batch plan. Transformations are
not ported yet, so the dependency check only verifies that the streamed
property exists. Plotting is not ported yet either.
"""

from __future__ import annotations

import abc
import logging
from typing import Any, Dict, List, Optional, Union

import numpy as np

from ..database.results_db import Computation
from ..database.trajectory_store import join_path
from ..memory.planner import BatchPlan

log = logging.getLogger(__name__)


class Calculator(abc.ABC):
    """Base orchestration for all calculators."""

    #: per-subject series outputs (e.g. x, y)
    result_series_keys: List[str] = []
    #: set once plotting has been reported as not ported
    _plot_notice_logged = False

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
            self.experiment = exp
            self.args = self.prepare_args(**kwargs)
            cache_args = dict(self.args)
            if force:
                exp.db.delete_computations(exp.name, self.name, cache_args)
            comp = exp.db.find_computation(
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
            if plot and not Calculator._plot_notice_logged:
                Calculator._plot_notice_logged = True
                log.info("plotting is not ported yet; pass plot=False")
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


class TrajectoryCalculator(Calculator):
    """Adds trajectory loading + the dependency check to Calculator."""

    #: property this calculator streams (PropertyInfo)
    loaded_property = None
    #: memory cost model (same spec format as the reference)
    scale_function: dict = {"linear": {"scale_factor": 1}}

    # ------------------------------------------------------------ dependencies
    def _run_dependency_check(self, species: Optional[List[str]] = None):
        """Check that the loaded property covers every configuration.

        The JAX package runs the transformation that produces a missing
        property; transformations are not ported yet, so this raises.
        """
        if self.loaded_property is None:
            return
        prop = self.loaded_property.name
        exp = self.experiment
        for sp in species or self.args.get("species", []):
            path = join_path(sp, prop)
            if (
                exp.store.check_existence(path)
                and exp.store.get_cursor(path) >= exp.number_of_configurations
            ):
                continue
            raise NotImplementedError(
                f"{self.name}: property {prop} is missing or incomplete for "
                f"species {sp}, and the transformation that would derive it "
                "is not ported yet (transformations are a later slice of the "
                "PyTorch port); ingest Positions directly."
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

    def selected_counts(self, species) -> List[int]:
        """Per-species particle counts after applying ``args['atom_selection']``."""
        counts = []
        for sp in species:
            sel = self.resolve_atom_selection(
                self.args.get("atom_selection"), sp
            )
            full = self.experiment.entity(sp).n_particles
            if sel is None:
                counts.append(full)
            elif isinstance(sel, slice):
                counts.append(len(range(*sel.indices(full))))
            else:
                counts.append(len(sel))
        return counts

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
    def _plan_for(self, paths: List[str]) -> BatchPlan:
        n_frames = self.experiment.number_of_configurations
        bytes_per_frame = 0
        for p in paths:
            _, n_atoms, n_dims = self.experiment.store.get_data_size(p)
            bytes_per_frame += n_atoms * n_dims * 8
        return self.experiment.planner.plan(
            n_frames=n_frames,
            bytes_per_frame=bytes_per_frame,
            scale_function=self.scale_function,
        )
