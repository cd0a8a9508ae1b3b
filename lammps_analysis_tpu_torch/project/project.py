"""Project: top-level container of experiments.

Counterpart of ``lammps_analysis_tpu/project/project.py`` (itself a port of
``mdsuite/project/project.py:45-338``): a project is a directory with
one SQLite results DB; experiments register themselves there and re-opening
``Project(name=...)`` restores everything. ``project.run.X(...)`` runs a
computation over all *active* experiments and returns a dict keyed by
experiment name. In a process group rank 0 alone writes the DB
(``parallel/multihost.py::shared``).
"""

from __future__ import annotations

import logging
import pathlib
from typing import Dict, List, Optional, Union

from ..database.results_db import ResultsDatabase
from ..experiment.experiment import Experiment
from ..experiment.run import RunComputation
from ..parallel.multihost import shared
from ..utils.units import UnitSystem

log = logging.getLogger(__name__)


class ExperimentMap(dict):
    """Experiments by name with attribute access (``exps.NaCl``)."""

    def __getattr__(self, name: str):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"no experiment named {name!r}; have {sorted(self)}"
            ) from None


class Project:
    """A directory-rooted collection of experiments with shared results DB."""

    def __init__(
        self,
        name: str = "MDSuite_Project",
        storage_path: Union[str, pathlib.Path] = "./",
        description: str = None,
    ):
        self.name = name
        self.path = pathlib.Path(storage_path) / name
        self.path.mkdir(parents=True, exist_ok=True)
        self.db = shared(ResultsDatabase, self.path / "project.db")
        self.description = description  # setter reads file paths (None ok)

        self.attach_file_logger()

        self._experiments: Dict[str, Experiment] = {}

    def attach_file_logger(self) -> None:
        """Attach the per-project DEBUG log file (idempotent).

        Runs automatically at construction; exposed as a method for API
        parity with the reference (``project.py:132-145``), where users
        call it explicitly.
        """
        handler_path = self.path / "mdsuite_tpu_torch.log"
        root = logging.getLogger("lammps_analysis_tpu_torch")
        if not any(
            isinstance(h, logging.FileHandler)
            and getattr(h, "baseFilename", None) == str(handler_path)
            for h in root.handlers
        ):
            fh = logging.FileHandler(handler_path)
            fh.setLevel(logging.DEBUG)
            root.addHandler(fh)

    @property
    def description(self) -> Optional[str]:
        return self.db.get_project_attribute("description")

    @description.setter
    def description(self, value: Optional[str]):
        """Persist a project description; a value naming an existing file
        (.md/.txt or anything else) stores that file's CONTENTS — the
        reference's contract (``database/project_database.py:68-88``)."""
        if value is None:
            return
        if pathlib.Path(value).exists():
            value = pathlib.Path(value).read_text()
        self.db.set_project_attribute("description", value)

    # ------------------------------------------------------------ experiments
    def add_experiment(
        self,
        name: str,
        timestep: float = None,
        temperature: float = None,
        units: Union[str, UnitSystem] = None,
        cluster_mode: bool = False,
        active: bool = True,
        simulation_data=None,
        update_with_pubchempy: bool = True,
    ) -> Experiment:
        """Create (or load) an experiment; optionally ingest data directly.

        Reference analog: ``Project.add_experiment`` (``project.py:157-249``;
        its ``update_with_pubchempy`` controls the element-mass lookup —
        here a bundled 118-element table instead of the pubchempy query).
        """
        exp = Experiment(
            project=self,
            name=name,
            time_step=timestep,
            temperature=temperature,
            units=units,
        )
        self.db.set_active(name, active)
        self._experiments[name] = exp
        if simulation_data is not None:
            exp.add_data(
                simulation_data, update_with_pubchempy=update_with_pubchempy
            )
        return exp

    @property
    def experiments(self) -> "ExperimentMap":
        """All experiments registered in the project DB.

        A dict that also supports attribute access by experiment name
        (``project.experiments.NaCl``) — the reference's own CI drives
        transformations that way
        (``CI/integration_tests/transformations/test_transformation_run_options.py:73``).
        """
        for name in self.db.list_experiments():
            if name not in self._experiments:
                self._experiments[name] = Experiment(project=self, name=name)
        return ExperimentMap(self._experiments)

    @property
    def active_experiments(self) -> "ExperimentMap":
        names = self.db.active_experiments()
        return ExperimentMap(
            {n: e for n, e in self.experiments.items() if n in names}
        )

    def activate_experiments(self, names: List[str]):
        """Reference analog: ``project.py:251-268``."""
        for n in names:
            self.db.set_active(n, True)

    def disable_experiments(self, names: List[str]):
        for n in names:
            self.db.set_active(n, False)

    def load_experiments(self, names):
        """Activate experiments by name (reference alias,
        ``project.py:247-249``). Accepts one name or a list."""
        if isinstance(names, str):
            names = [names]
        self.activate_experiments(names)

    def add_data(self, data_sets: Dict[str, object]) -> None:
        """Ingest data into several experiments at once.

        ``data_sets`` maps experiment name -> simulation data (any form
        ``Experiment.add_data`` accepts). Reference analog:
        ``project.py:286-306``.
        """
        experiments = self.experiments
        missing = [n for n in data_sets if n not in experiments]
        if missing:
            raise KeyError(
                f"Unknown experiment(s) {missing}; create them with "
                "add_experiment first."
            )
        for name, data in data_sets.items():
            experiments[name].add_data(data)

    # ------------------------------------------------------------------ runs
    @property
    def run(self) -> RunComputation:
        """Run a computation across all active experiments."""
        return RunComputation(experiments=list(self.active_experiments.values()))

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Project(name={self.name!r}, experiments={list(self.experiments)})"
