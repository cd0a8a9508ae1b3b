"""The port's results DB (``database/results_db.py``) and its contract: a
read writes nothing, not even for an experiment the file does not hold; each
thread keeps one connection for all of its queries and sees what other
threads and other database objects on the file wrote; a delete needs no
experiment row; a forced call deletes and recomputes without probing the
cache it has just emptied."""

import concurrent.futures
import threading

import pytest

import lammps_analysis_tpu_torch as lt
from lammps_analysis_tpu_torch.calculators.base import Calculator
from lammps_analysis_tpu_torch.database.results_db import ResultsDatabase
from torch_worlds import db_connections, db_writes

ARGS = {"cutoff": 3.0, "bins": [1, 2]}
RESULTS = {"Na_Cl": {"x": [0.5, 1.5], "y": [1.0, 2.0]}}


def _filled(path) -> ResultsDatabase:
    """A DB holding experiment ``e``: an attribute, a bumped version, one
    computation and a project attribute."""
    db = ResultsDatabase(path)
    db.set_attribute("e", "temperature", 300.0)
    db.bump_experiment_version("e")
    db.store_computation("e", "RDF", ARGS, 1, RESULTS)
    db.set_project_attribute("description", "melt")
    return db


#: a read of experiment ``ghost``, which the file does not hold, and its answer
READS = {
    "get_attribute": (lambda db: db.get_attribute("ghost", "temperature", "none"), "none"),
    "find_computation": (lambda db: db.find_computation("ghost", "RDF", ARGS, 1), None),
    "list_computations": (lambda db: db.list_computations("ghost"), []),
    "experiment_version": (lambda db: db.experiment_version("ghost"), 0),
    "get_project_attribute": (lambda db: db.get_project_attribute("ghost", "none"), "none"),
}


@pytest.mark.parametrize("method", sorted(READS))
def test_a_read_of_an_unknown_experiment_writes_nothing(tmp_path, method):
    read, answer = READS[method]
    with db_connections() as connections:
        db = _filled(tmp_path / "project.db")
        done = [len(statements) for _, statements in connections]
        assert read(db) == answer
    done += [0] * (len(connections) - len(done))
    assert [db_writes(statements[n:]) for n, (_, statements) in zip(done, connections)] \
        == [[]] * len(connections)
    assert db.list_experiments() == ["e"]


def test_one_connection_a_thread_sees_every_write(tmp_path):
    """A value written on the main thread is read on a worker thread and
    through a second database object on the file; a later write is read by
    both again. Each thread opens one connection a database object."""
    path = tmp_path / "project.db"
    with db_connections() as connections, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
        db = _filled(path)

        def reads(source):
            return (source.get_attribute("e", "temperature"), source.experiment_version("e"),
                    source.find_computation("e", "RDF", ARGS, 1).data_dict,
                    [c["name"] for c in source.list_computations("e")])

        expected = (300.0, 1, RESULTS, ["RDF"])
        worker = pool.submit(reads, db).result()
        other = ResultsDatabase(path)
        assert worker == reads(other) == reads(db) == expected
        db.set_attribute("e", "temperature", 350.0)
        assert pool.submit(db.get_attribute, "e", "temperature").result() == 350.0
        assert other.get_attribute("e", "temperature") == 350.0
        worker_thread = pool.submit(threading.get_ident).result()
    main = threading.get_ident()
    assert [thread for thread, _ in connections] == [main, worker_thread, main]


def test_delete_needs_no_experiment_row(tmp_path):
    """``delete_computations`` removes the exact-args match, then every run
    of the calculator, with their results; for an unknown experiment it
    deletes nothing and adds no row."""
    db = _filled(tmp_path / "project.db")
    other = {**ARGS, "cutoff": 4.0}
    db.store_computation("e", "RDF", other, 1, RESULTS)
    db.store_computation("e", "ADF", ARGS, 1, RESULTS)
    assert db.delete_computations("ghost", "RDF") == 0
    assert db.list_experiments() == ["e"]
    assert db.delete_computations("e", "RDF", ARGS) == 1
    assert db.find_computation("e", "RDF", ARGS, 1) is None
    assert db.find_computation("e", "RDF", other, 1).data_dict == RESULTS
    assert db.delete_computations("e", "RDF") == 1
    assert [c["name"] for c in db.list_computations("e")] == ["ADF"]
    con = db._connection()
    (n_results,) = con.execute("SELECT COUNT(*) FROM computation_results").fetchone()
    assert n_results == len(RESULTS)


class Count(Calculator):
    """A calculator without a trajectory: its result counts its runs."""

    def prepare_args(self, **kwargs):
        return dict(kwargs)

    def run_calculator(self):
        self.runs = getattr(self, "runs", 0) + 1
        return {"System": {"runs": self.runs}}


@pytest.mark.parametrize("force, probes, runs", [(False, 1, 1), (True, 0, 2)])
def test_a_forced_call_does_not_probe_the_cache(tmp_path, monkeypatch, force, probes, runs):
    """After a first call, an unforced call probes the cache once and hits;
    a forced one deletes, recomputes and stores without a probe."""
    exp = lt.Experiment(name="e", storage_path=tmp_path)
    calc = Count(experiment=exp, plot=False)
    calc(window=4)
    find = ResultsDatabase.find_computation
    seen = []

    def counted(self, *args, **kwargs):
        seen.append(args)
        return find(self, *args, **kwargs)

    monkeypatch.setattr(ResultsDatabase, "find_computation", counted)
    comp = calc(window=4, force=force)
    assert len(seen) == probes
    assert comp["System"] == {"runs": runs} and calc.runs == runs
    assert [c["name"] for c in exp.db.list_computations("e")] == ["Count"]
