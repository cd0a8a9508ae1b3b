"""PyTorch port, the multi-device layer on the CPU: worlds of 2 and 4 gloo
ranks (``parallel/multihost.py::launch_local``, a ``file://`` rendezvous
under ``tmp_path`` and a join timeout) running the sharded ops and the
calculators over the port's meshes, held against the JAX package on its
8-device CPU mesh (``tests/test_multidevice.py``'s cases) and against the
port's own one-process result. The mesh size does not change the result, so
a world of 4 against JAX's 8 devices is a fair comparison.

The rank bodies live in ``tests/torch_worlds.py``, which imports no jax: the
ranks are processes of their own. Each world runs once per module and
several tests read it.

Tolerances: histograms of the port equal as integers across mesh sizes; the
port's RDF against JAX's XLA histogram, equal totals and at most a few
counts in a neighbouring bin (the XLA function divides by the box where the
port multiplies by float32 reciprocals, ``ROADMAP.md`` "Before filing a
fault"); ADF totals within rtol 1e-5 and at most max(2, size // 64) bins
outside rtol 1e-4; transport within rtol 1e-5 (plus 1e-5 x acf[0] for an
ACF).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_worlds
from lammps_analysis_tpu.ops import adf as jax_adf
from lammps_analysis_tpu.ops import rdf as jax_rdf
from lammps_analysis_tpu.parallel import sharded_ops as jax_sharded
from lammps_analysis_tpu.parallel.mesh import make_2d_mesh as jax_2d_mesh
from lammps_analysis_tpu.parallel.mesh import make_data_mesh as jax_data_mesh
from lammps_analysis_tpu.parallel.mesh import use_mesh as jax_use_mesh
from lammps_analysis_tpu.utils.config import config as jax_config
from lammps_analysis_tpu_torch.parallel import data_sharding, dryrun_multichip, multihost
from lammps_analysis_tpu_torch.parallel.mesh import Mesh, make_data_mesh
from lammps_analysis_tpu_torch.utils.config import config
from torch_dumps import assert_einstein_close, assert_gk_close

torch.set_num_threads(1)
JAX_MESH = jax_data_mesh(8)


@pytest.fixture(scope="module", autouse=True)
def cpu_device():
    old, native = config.device, jax_config.native_cpu_kernels
    config.device, jax_config.native_cpu_kernels = "cpu", False
    yield
    config.device, jax_config.native_cpu_kernels = old, native


@pytest.fixture(scope="module")
def op_world(tmp_path_factory):
    """Every rank's results of ``torch_worlds.op_world`` in a world of 4."""
    return multihost.launch_local(4, torch_worlds.op_world,
                                  workdir=tmp_path_factory.mktemp("ops"), timeout=240)


@pytest.fixture(scope="module")
def one_device():
    return torch_worlds.one_device_ops()


@pytest.fixture(scope="module")
def calc_world(tmp_path_factory):
    root = tmp_path_factory.mktemp("calculators")
    return multihost.launch_local(4, torch_worlds.calculator_world, root,
                                  workdir=tmp_path_factory.mktemp("calc-world"), timeout=240)


@pytest.fixture(scope="module")
def one_device_calcs(tmp_path_factory):
    return torch_worlds.calculators(tmp_path_factory.mktemp("one"))


@pytest.fixture(scope="module")
def jax_calcs(tmp_path_factory):
    exp = torch_worlds.nacl_experiment("lammps_analysis_tpu", tmp_path_factory.mktemp("jax"))
    with jax_use_mesh(JAX_MESH):
        return {name: getattr(exp.run, name)(plot=False, **kw).data_dict
                for name, kw in torch_worlds.CALCULATORS.items()}


def _assert_counts_close(ours, ref):
    ours, ref = np.asarray(ours, np.int64), np.rint(np.asarray(ref)).astype(np.int64)
    assert ours.shape == ref.shape and ref.sum() > 0
    assert ours.sum() == ref.sum()
    assert np.abs(ours - ref).sum() <= 4, "more than a few counts in another bin"


def _assert_adf_close(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape and ref.sum() > 0
    np.testing.assert_allclose(ours.sum(), ref.sum(), rtol=1e-5)
    bad = ~np.isclose(ours, ref, rtol=1e-4, atol=1e-6)
    assert bad.sum() <= max(2, ref.size // 64), f"{bad.sum()} bins differ"


def _jax_system():
    sid, pos = torch_worlds.system()
    _, _, ptab, n_pairs, _ = jax_rdf.build_species_layout([24, 16], pad_to=8)
    box = jnp.asarray(np.asarray(torch_worlds.BOX))
    return jnp.asarray(sid), jnp.asarray(pos), jnp.asarray(ptab), n_pairs, box


# ---------------------------------------------------------------- the ops
def test_every_rank_holds_the_merged_result(op_world):
    for key, value in op_world[0].items():
        if key == "plain calls":
            continue
        for rank, results in enumerate(op_world[1:], start=1):
            np.testing.assert_array_equal(results[key], value, err_msg=f"{key} on rank {rank}")


def test_every_rank_ran_its_own_shard(op_world):
    rdf_calls, extract_calls = np.array([r["plain calls"] for r in op_world]).T
    assert (rdf_calls > 0).all() and (extract_calls > 0).all()


@pytest.mark.parametrize("label, n_frames", [("all", 16), ("remainder", 13), ("few frames", 3)])
def test_rdf_matches_jax_and_one_device(op_world, one_device, label, n_frames):
    """Frames over the data mesh, 16, 13 (a remainder) and 3 (fewer frames
    than ranks) of them: the one-process counts exactly, JAX's 8 devices
    within the bin allowance."""
    sid, pos, ptab, n_pairs, box = _jax_system()
    with jax_use_mesh(JAX_MESH):
        ref = jax_sharded.sharded_rdf_histogram(
            pos[:n_frames], sid, ptab, box, cutoff=2.4, n_bins=60, n_pairs=n_pairs, i_block=8,
        )
    ours = op_world[0][f"rdf {label}"]
    np.testing.assert_array_equal(ours, one_device[f"rdf {label}"])
    _assert_counts_close(ours, np.asarray(ref))


@pytest.fixture(scope="module")
def jax_rdf_2d():
    sid, pos, ptab, n_pairs, box = _jax_system()
    return np.asarray(jax_sharded.sharded_rdf_histogram_2d(
        pos, sid, ptab, box, cutoff=2.4, n_bins=60, n_pairs=n_pairs, mesh=jax_2d_mesh(2, 4),
    ))


@pytest.mark.parametrize("key", ["rdf 2d", "rdf 2d routed"])
def test_rdf_2d_matches_jax_2d_mesh(op_world, one_device, jax_rdf_2d, key):
    """Frames over ``data`` and K1's i-rows over ``atoms`` on a (2, 2) mesh,
    directly and routed from ``sharded_rdf_histogram``: the one-process
    counts exactly; JAX's ``sharded_rdf_histogram_2d`` on a (2, 4) mesh."""
    np.testing.assert_array_equal(op_world[0][key], one_device["rdf all"])
    _assert_counts_close(op_world[0][key], jax_rdf_2d)


@pytest.mark.parametrize("label, n_frames", [("all", 16), ("remainder", 13), ("few frames", 3)])
def test_adf_matches_jax_and_one_device(op_world, one_device, label, n_frames):
    sid, pos, _, _, box = _jax_system()
    ttab, order = jax_adf.build_triple_table(2)
    with jax_use_mesh(JAX_MESH):
        ref = jax_sharded.sharded_adf_histogram(
            pos[:n_frames], sid, jnp.asarray(ttab), box, cutoff=2.0, n_bins=36,
            n_triples=len(order), c_block=8,
        )
    _assert_adf_close(op_world[0][f"adf {label}"], one_device[f"adf {label}"])
    _assert_adf_close(op_world[0][f"adf {label}"], np.asarray(ref))


def test_adf_stripes_match_jax_stripe_extract(op_world, one_device):
    """The 2-D ADF: frames over ``data``, K2's center stripes over
    ``atoms``, directly and routed from ``sharded_adf_histogram``, against
    JAX's ``sharded_adf_histogram_2d`` with its stripe extract and
    ``adf_stage2_auto`` in interpret mode (as ``__graft_entry__.py`` runs
    them) and against the one-process ADF."""
    import functools

    from lammps_analysis_tpu.ops import pallas_adf

    c = torch_worlds.STRIPES
    sid, pos = torch_worlds.stripes_system()
    ttab, order = jax_adf.build_triple_table(2)
    plan = jax_sharded._AdfPlan(c["n_atoms"], np.array([c["box"]] * 3), c["cutoff"], use_pallas=True)
    plan.use_sorted = True
    plan.w_chunks = c["n_atoms"] // 128
    saved = {f: getattr(pallas_adf, f) for f in ("sorted_neighbor_extract_stripe", "adf_stage2_auto")}
    try:
        for f, fn in saved.items():
            setattr(pallas_adf, f, functools.partial(fn, interpret=True))
        ref = jax_sharded.sharded_adf_histogram_2d(
            jnp.asarray(pos, jnp.float32), jnp.asarray(sid), jnp.asarray(ttab),
            jnp.asarray(np.array([c["box"]] * 3, np.float32)), cutoff=c["cutoff"],
            n_bins=c["n_bins"], n_triples=len(order), mesh=jax_2d_mesh(4, 2), plan=plan,
        )
    finally:
        for f, fn in saved.items():
            setattr(pallas_adf, f, fn)
    for key in ("adf stripes", "adf stripes routed"):
        _assert_adf_close(op_world[0][key], np.asarray(ref))
        _assert_adf_close(op_world[0][key], one_device["adf stripes"])


def test_one_frame_batches_rotate_over_the_ranks(op_world, one_device):
    """Four one-frame normalisation batches over four ranks: each rank
    extracts one of them (the remainder turns with the batch count), and
    the per-batch normalised sum is the one-process one."""
    assert [int(r["one-frame batch extracts"][0]) for r in op_world] == [1, 1, 1, 1]
    assert int(one_device["one-frame batch extracts"][0]) == 4
    _assert_adf_close(op_world[0]["adf one-frame batches"], one_device["adf one-frame batches"])


def test_saturated_adf_escalates_on_every_rank(op_world, one_device):
    """Only the last frame (rank 3's) saturates K; the largest count is
    reduced over the ranks, so every rank widens K and feeds again."""
    assert all((r["adf saturated passes, K"] == [2, 64]).all() for r in op_world)
    np.testing.assert_array_equal(one_device["adf saturated passes, K"], [2, 64])
    _assert_adf_close(op_world[0]["adf saturated"], one_device["adf saturated"])


@pytest.mark.parametrize("name", ["msd", "msd remainder", "msd empty rank"])
def test_windowed_msd_matches_jax_and_one_device(op_world, one_device, name):
    x, window, stride = torch_worlds.walks()[name]
    with jax_use_mesh(JAX_MESH):
        ref, _ = jax_sharded.sharded_windowed_msd(
            jnp.asarray(torch_worlds.f32(x)), jnp.arange(window), window=window, stride=stride,
        )
    np.testing.assert_allclose(op_world[0][name], one_device[name], rtol=1e-5)
    np.testing.assert_allclose(op_world[0][name], np.asarray(ref), rtol=1e-5)


def test_windowed_msd_on_a_2d_mesh_uses_every_rank(op_world, one_device):
    np.testing.assert_allclose(op_world[0]["msd 2d"], one_device["msd"], rtol=1e-5)


@pytest.mark.parametrize("name", ["acf", "acf empty rank"])
def test_windowed_acf_matches_jax_and_one_device(op_world, one_device, name):
    """The ACF sum and the count-weighted per-window particle mean, with a
    remainder (19 particles) and a rank without particles (3)."""
    x, window, stride = torch_worlds.walks()[name]
    ref = jax_sharded.sharded_windowed_acf(
        jnp.asarray(torch_worlds.f32(x)), window=window, stride=stride, mesh=JAX_MESH,
    )
    for key, expected in ((name, np.asarray(ref[0])), (name + " per window", np.asarray(ref[1]))):
        scale = np.abs(expected).max()
        for value in (one_device[key], expected):
            np.testing.assert_allclose(op_world[0][key], value, rtol=1e-5, atol=1e-5 * scale,
                                       err_msg=key)


# ----------------------------------------------------------- the calculators
@pytest.mark.parametrize("name", list(torch_worlds.CALCULATORS))
def test_calculators_match_jax_on_8_devices(calc_world, jax_calcs, name):
    ours, ref = calc_world[0]["results"][name], jax_calcs[name]
    assert set(ours) == set(ref)
    if name == "RadialDistributionFunction":
        for key in ref:
            np.testing.assert_allclose(ours[key]["x"], ref[key]["x"], rtol=1e-12)
            np.testing.assert_allclose(ours[key]["y"], ref[key]["y"], rtol=1e-6, err_msg=key)
    elif name == "AngularDistributionFunction":
        for key in ref:
            _assert_adf_close(ours[key]["adf"], ref[key]["adf"])
    elif name == "EinsteinDiffusionCoefficients":
        assert_einstein_close(ours, ref)
    else:
        assert_gk_close(ours, ref)


@pytest.mark.parametrize("name", [*torch_worlds.CALCULATORS, "walk Einstein"])
def test_calculators_match_one_device(calc_world, one_device_calcs, name):
    """Every rank returns the one-process result: counts exactly (the same
    g(r)), the ADF within its allowance, transport within rtol 1e-5."""
    ref = one_device_calcs[name]
    for rank, world in enumerate(calc_world):
        ours = world["results"][name]
        if name == "RadialDistributionFunction":
            assert ours == ref, f"rank {rank}"
        elif name == "AngularDistributionFunction":
            for key in ref:
                _assert_adf_close(ours[key]["adf"], ref[key]["adf"])
        elif name == "GreenKuboDiffusionCoefficients":
            assert_gk_close(ours, ref)
        else:
            assert_einstein_close(ours, ref)


def test_rank_zero_writes_and_the_cache_hits(calc_world):
    """Rank 0 alone wrote the store (the ingests and the unwrap that the walk
    Einstein's dependency check ran), one DB row per computation, and the
    second calls were cache hits on every rank: no collective."""
    writes = [w["writes"] for w in calc_world]
    assert "Na/Unwrapped_Positions" in writes[0] and "Na/Positions" in writes[0]
    assert writes[1:] == [[], [], []]
    expected_rows = [*torch_worlds.CALCULATORS, "EinsteinDiffusionCoefficients"]
    for world in calc_world:
        assert world["rows"] == expected_rows
        assert world["again_equal"] and world["collectives"] > 0 and world["collectives_again"] == 0


def test_planner_budget_is_shared_among_the_ranks_of_a_device(calc_world):
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    for world in calc_world:
        assert world["budget"] == int(host * config.memory_fraction / 4)


# -------------------------------------------------------------- the plumbing
def test_dryrun_multichip_prints_the_jax_sums(tmp_path):
    """``dryrun_multichip(4)`` spawns a world of 4 and prints the sums that
    ``__graft_entry__.dryrun_multichip(4)`` of the JAX package prints on 4
    CPU devices: rdf hist sum=1836, 2d-mesh sum=1836, adf2d stripes
    sum=6161787.500, msd windows=7, acf[0]=83.225, calc rdf g(r)
    sum=111.455, calc adf sum=45.714."""
    line = dryrun_multichip(4)
    sums = dict(re.findall(r"([\w\[\]\-() ]+?)=([-\d.]+)", line.split(": ", 1)[1]))
    values = {k.strip(", "): float(v) for k, v in sums.items()}
    assert values["rdf hist sum"] == values["2d-mesh sum"] == 1836
    assert values["msd windows"] == 7
    np.testing.assert_allclose(values["adf2d stripes sum"], 6161787.5, rtol=1e-5)
    for key, jax_value in (("acf[0]", 83.225), ("calc rdf g(r) sum", 111.455),
                           ("calc adf sum", 45.714)):
        assert abs(values[key] - jax_value) <= 1e-3, key


def test_a_failing_rank_stops_its_world(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        multihost.launch_local(2, torch_worlds.failing_world, workdir=tmp_path, timeout=120)


@pytest.mark.parametrize("n, parts", [(0, 4), (3, 4), (13, 4), (16, 4), (40, 2), (7, 1)])
def test_data_sharding_covers_every_index_once(n, parts):
    ranges = []
    for rank in range(parts):
        mesh = Mesh({"data": parts})
        mesh.rank = rank
        ranges.append(data_sharding(mesh, n))
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert sizes == sorted(sizes, reverse=True) and max(sizes) - min(sizes) <= 1
    for turn in range(1, parts + 1):  # a turn rotates the same parts over the ranks
        turned = []
        for rank in range(parts):
            mesh = Mesh({"data": parts})
            mesh.rank = rank
            turned.append(data_sharding(mesh, n, turn=turn))
        assert turned == [ranges[(r - turn) % parts] for r in range(parts)]


def test_without_a_group_the_mesh_is_this_process():
    mesh = make_data_mesh()
    assert mesh.size == 1 and mesh.group is None
    assert data_sharding(mesh, 5) == (0, 5)
    assert multihost.rank_zero(lambda x: x + 1)(1) == 2  # runs as it is
    with pytest.raises(ValueError, match="a mesh spans every rank"):
        make_data_mesh(2)
    with pytest.raises(RuntimeError, match="torchrun"):
        multihost.initialize()


@pytest.mark.parametrize("hosts", [
    ["a"] * 4 + ["b"] * 4,  # two hosts of four ranks (4 cards each: one a card)
    ["a", "b"] * 3,  # ranks numbered across hosts in turn
    ["a"] * 3,  # one host
])
def test_the_local_world_is_the_ranks_of_this_host(hosts):
    """Ranks that start with a coordinator address on several hosts (no
    torchrun environment) find their host's ranks through the rendezvous
    store: each posts its host name and counts the ranks that share it."""
    import threading

    store, n = torch.distributed.HashStore(), len(hosts)
    found = [None] * n

    def rank_body(r):
        found[r] = multihost.local_world_of(store, r, n, host=hosts[r])

    threads = [threading.Thread(target=rank_body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for r, host in enumerate(hosts):
        same = [q for q, h in enumerate(hosts) if h == host]
        assert found[r] == (same.index(r), len(same))


def test_shared_storage_writes_through_rank_zero_and_reads_as_it_is(tmp_path):
    """``multihost.shared`` wraps the store and the DB: the methods of their
    ``WRITES`` go through ``rank_zero`` (as they are without a group), the
    reads and attributes are the object's own."""
    from lammps_analysis_tpu_torch.database.results_db import ResultsDatabase
    from lammps_analysis_tpu_torch.database.trajectory_store import TrajectoryStore

    db = multihost.shared(ResultsDatabase, tmp_path / "project.db")
    assert isinstance(db, multihost.RankZeroWrites) and db.path == tmp_path / "project.db"
    db.set_attribute("e", "temperature", 300.0)
    assert db.get_attribute("e", "temperature") == 300.0
    assert db.set_attribute.__wrapped__ == db._target.set_attribute
    assert not hasattr(db.get_attribute, "__wrapped__")
    store = multihost.shared(TrajectoryStore, tmp_path / "database")
    store.ensure_dataset("Na", "Positions", 3, 2, 3)
    store.append("Na/Positions", np.ones((3, 2, 3), np.float32))
    assert store.get_cursor("Na/Positions") == 3 and store.check_existence("Na/Positions")
    for cls in (ResultsDatabase, TrajectoryStore):
        assert all(callable(getattr(cls, name)) for name in cls.WRITES)


def test_a_world_runs_on_config_device_by_default(tmp_path, monkeypatch):
    """``launch_local`` (and so ``dryrun_multichip``) runs its ranks on
    ``config.device`` unless the caller names a device: with "cuda" and no
    card here, the ranks refuse to start."""
    import pickle

    monkeypatch.setattr(config, "device", "cuda")
    with pytest.raises(RuntimeError, match="finds no CUDA device"):
        multihost.launch_local(1, torch_worlds.failing_world, workdir=tmp_path, timeout=120)
    assert pickle.loads((tmp_path / "spec.pkl").read_bytes())["device"] == "cuda"
