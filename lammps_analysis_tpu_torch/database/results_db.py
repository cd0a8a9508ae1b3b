"""Project metadata + results database (SQLite, stdlib ``sqlite3``).

Replaces the reference's SQLAlchemy ORM stack (``mdsuite/database/scheme.py``,
``database_base.py``, ``experiment_database.py``, ``calculator_database.py``)
with a compact schema holding the same information:

* ``experiments`` — one row per experiment (+ monotonically bumped ``version``
  used to invalidate cached results when new data is ingested; reference:
  ``experiment/experiment.py:547``);
* ``experiment_attributes`` — JSON key/value attributes (temperature,
  time_step, species, box, units, read_files ledger, ...; reference:
  ``experiment_database.py:80-433``);
* ``computations`` / ``computation_results`` — full provenance cache: a
  calculator re-run with identical canonical args and experiment version is a
  lookup, not a recompute (reference: ``calculator_database.py:103-172``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import sqlite3
import time
from typing import Any, Dict, List, Optional, Union

import numpy as np

_SCHEMA = """
CREATE TABLE IF NOT EXISTS experiments (
    id INTEGER PRIMARY KEY,
    name TEXT UNIQUE NOT NULL,
    active INTEGER DEFAULT 1,
    version INTEGER DEFAULT 0
);
CREATE TABLE IF NOT EXISTS experiment_attributes (
    experiment_id INTEGER NOT NULL,
    name TEXT NOT NULL,
    value TEXT,
    PRIMARY KEY (experiment_id, name),
    FOREIGN KEY (experiment_id) REFERENCES experiments(id)
);
CREATE TABLE IF NOT EXISTS computations (
    id INTEGER PRIMARY KEY,
    experiment_id INTEGER NOT NULL,
    name TEXT NOT NULL,
    args_key TEXT NOT NULL,
    args_json TEXT NOT NULL,
    experiment_version INTEGER NOT NULL,
    created REAL NOT NULL,
    FOREIGN KEY (experiment_id) REFERENCES experiments(id)
);
CREATE INDEX IF NOT EXISTS idx_computations_lookup
    ON computations (experiment_id, name, args_key, experiment_version);
CREATE TABLE IF NOT EXISTS computation_results (
    computation_id INTEGER NOT NULL,
    subjects TEXT NOT NULL,
    data TEXT NOT NULL,
    FOREIGN KEY (computation_id) REFERENCES computations(id)
);
CREATE TABLE IF NOT EXISTS project_attributes (
    name TEXT PRIMARY KEY,
    value TEXT
);
"""


def _json_default(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, slice):
        return {"__slice__": [obj.start, obj.stop, obj.step]}
    if dataclasses.is_dataclass(obj):
        return dataclasses.asdict(obj)
    raise TypeError(f"Cannot serialize {type(obj)} to the results DB")


def canonical_json(obj: Any) -> str:
    """Deterministic JSON used as the computation cache key.

    Analog of the reference arg serialization (``conv_to_db``,
    ``calculator_database.py:60-88``).
    """
    return json.dumps(obj, sort_keys=True, default=_json_default)


def ordered_json(obj: Any) -> str:
    """Order-preserving JSON for attribute values (species order matters)."""
    return json.dumps(obj, default=_json_default)


class Computation:
    """A cached computation: args + per-subject result series.

    Analog of the reference ORM ``Computation`` row and its assembled
    ``data_dict`` (``mdsuite/database/scheme.py:226-268``). Subject keys are
    ``"_"``-joined species tuples (``"Na_Cl"``), ``"System"`` for system-wide
    observables.
    """

    def __init__(self, name: str, args: dict, data_dict: Dict[str, dict],
                 experiment: str = None):
        self.name = name
        self.args = dict(args)
        self.data_dict = data_dict
        self.experiment = experiment

    def __getitem__(self, subject: Union[str, tuple]):
        if isinstance(subject, (tuple, list)):
            subject = "_".join(subject)
        return self.data_dict[subject]

    def keys(self):
        return self.data_dict.keys()

    @property
    def computation_parameter(self) -> dict:
        return self.args

    @property
    def data_range(self):
        """Window length of the computation (reference ``scheme.py:329``)."""
        return self.args.get("data_range")

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"Computation({self.name}, subjects={list(self.data_dict)})"


class ResultsDatabase:
    """One SQLite file per project, shared by all experiments."""

    #: the methods that write the file; the others read
    WRITES = frozenset({
        "ensure_experiment", "bump_experiment_version", "set_active", "set_attribute",
        "set_project_attribute", "store_computation", "delete_computations",
    })

    def __init__(self, path: Union[str, pathlib.Path]):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with self._connect() as con:
            con.executescript(_SCHEMA)

    def _connect(self) -> sqlite3.Connection:
        con = sqlite3.connect(self.path)
        con.execute("PRAGMA journal_mode=WAL")
        return con

    # ------------------------------------------------------------ experiments
    def ensure_experiment(self, name: str) -> int:
        with self._connect() as con:
            con.execute(
                "INSERT OR IGNORE INTO experiments (name) VALUES (?)", (name,)
            )
            (eid,) = con.execute(
                "SELECT id FROM experiments WHERE name=?", (name,)
            ).fetchone()
        return int(eid)

    def list_experiments(self) -> List[str]:
        with self._connect() as con:
            rows = con.execute("SELECT name FROM experiments ORDER BY id").fetchall()
        return [r[0] for r in rows]

    def experiment_version(self, name: str) -> int:
        with self._connect() as con:
            row = con.execute(
                "SELECT version FROM experiments WHERE name=?", (name,)
            ).fetchone()
        return int(row[0]) if row else 0

    def bump_experiment_version(self, name: str) -> int:
        with self._connect() as con:
            con.execute(
                "UPDATE experiments SET version = version + 1 WHERE name=?", (name,)
            )
            (v,) = con.execute(
                "SELECT version FROM experiments WHERE name=?", (name,)
            ).fetchone()
        return int(v)

    def set_active(self, name: str, active: bool):
        with self._connect() as con:
            con.execute(
                "UPDATE experiments SET active=? WHERE name=?", (int(active), name)
            )

    def active_experiments(self) -> List[str]:
        with self._connect() as con:
            rows = con.execute(
                "SELECT name FROM experiments WHERE active=1 ORDER BY id"
            ).fetchall()
        return [r[0] for r in rows]

    # -------------------------------------------------------------- attributes
    def set_attribute(self, experiment: str, name: str, value: Any):
        eid = self.ensure_experiment(experiment)
        with self._connect() as con:
            con.execute(
                "INSERT OR REPLACE INTO experiment_attributes VALUES (?,?,?)",
                (eid, name, ordered_json(value)),
            )

    def get_attribute(self, experiment: str, name: str, default=None):
        eid = self.ensure_experiment(experiment)
        with self._connect() as con:
            row = con.execute(
                "SELECT value FROM experiment_attributes "
                "WHERE experiment_id=? AND name=?",
                (eid, name),
            ).fetchone()
        if row is None:
            return default
        return json.loads(row[0])

    def set_project_attribute(self, name: str, value: Any):
        with self._connect() as con:
            con.execute(
                "INSERT OR REPLACE INTO project_attributes VALUES (?,?)",
                (name, canonical_json(value)),
            )

    def get_project_attribute(self, name: str, default=None):
        with self._connect() as con:
            row = con.execute(
                "SELECT value FROM project_attributes WHERE name=?", (name,)
            ).fetchone()
        return default if row is None else json.loads(row[0])

    # ------------------------------------------------------------ computations
    def find_computation(
        self, experiment: str, calc_name: str, args: dict, version: int
    ) -> Optional[Computation]:
        """Cache probe — exact match on canonical args + experiment version.

        Reference analog: ``CalculatorDatabase.get_computation_data``
        (``calculator_database.py:103-172``).
        """
        eid = self.ensure_experiment(experiment)
        args_key = canonical_json(args)
        with self._connect() as con:
            row = con.execute(
                "SELECT id, args_json FROM computations WHERE experiment_id=? "
                "AND name=? AND args_key=? AND experiment_version=? "
                "ORDER BY id DESC LIMIT 1",
                (eid, calc_name, args_key, version),
            ).fetchone()
            if row is None:
                return None
            cid, args_json = row
            results = con.execute(
                "SELECT subjects, data FROM computation_results "
                "WHERE computation_id=?",
                (cid,),
            ).fetchall()
        data_dict = {subjects: json.loads(data) for subjects, data in results}
        return Computation(calc_name, json.loads(args_json), data_dict, experiment)

    def store_computation(
        self,
        experiment: str,
        calc_name: str,
        args: dict,
        version: int,
        results: Dict[str, dict],
    ) -> Computation:
        """Persist a finished computation with full provenance."""
        eid = self.ensure_experiment(experiment)
        args_key = canonical_json(args)
        with self._connect() as con:
            cur = con.execute(
                "INSERT INTO computations "
                "(experiment_id, name, args_key, args_json, experiment_version,"
                " created) VALUES (?,?,?,?,?,?)",
                # args_json preserves the CALL's argument order (species
                # order matters for provenance); args_key is the
                # sort-keyed cache lookup form
                (
                    eid, calc_name, args_key, ordered_json(args), version,
                    time.time(),
                ),
            )
            cid = cur.lastrowid
            for subjects, data in results.items():
                con.execute(
                    "INSERT INTO computation_results VALUES (?,?,?)",
                    (cid, subjects, canonical_json(data)),
                )
        # round-trip through JSON so fresh and cache-loaded Computations
        # expose identical arg types (tuples -> lists etc.), in call order
        return Computation(
            calc_name, json.loads(ordered_json(args)), dict(results),
            experiment,
        )

    def delete_computations(
        self, experiment: str, calc_name: str, args: Optional[dict] = None
    ) -> int:
        """Invalidate cached computations; returns the number deleted.

        ``args=None`` deletes every cached run of the calculator for the
        experiment; with ``args`` only the exact canonical-args match is
        removed. This is the user-facing \"force recompute\" hook — the
        next identical call recomputes instead of hitting the cache.
        """
        eid = self.ensure_experiment(experiment)
        where = "experiment_id=? AND name=?"
        params: list = [eid, calc_name]
        if args is not None:
            where += " AND args_key=?"
            params.append(canonical_json(args))
        with self._connect() as con:
            ids = [
                r[0]
                for r in con.execute(
                    f"SELECT id FROM computations WHERE {where}", params
                )
            ]
            for cid in ids:
                con.execute(
                    "DELETE FROM computation_results WHERE computation_id=?",
                    (cid,),
                )
                con.execute("DELETE FROM computations WHERE id=?", (cid,))
        return len(ids)

    def list_computations(self, experiment: str) -> List[dict]:
        eid = self.ensure_experiment(experiment)
        with self._connect() as con:
            rows = con.execute(
                "SELECT name, args_json, experiment_version, created "
                "FROM computations WHERE experiment_id=? ORDER BY id",
                (eid,),
            ).fetchall()
        return [
            {"name": n, "args": json.loads(a), "experiment_version": v, "created": c}
            for n, a, v, c in rows
        ]
