"""PyTorch port, the molecular path: SMILES parsing, the cutoff adjacency,
molecule detection, the bond-graph check and ``MolecularMap``, held against
the JAX package on the same inputs.

The port's bond-graph check is its own backtracking search (the JAX package
asks networkx's VF2); it must give networkx's answer on every case here.
``MolecularMap`` must give the JAX package's ``experiment.molecules``
record and, on molecules that are whole at the first frame, its COM within
1e-4 A (the port stores float32, the JAX package float64 under x64). On
molecules that straddle a box face at the first frame the port gives the
true COM (up to a whole box vector, the image of the molecule's first atom)
and the JAX package does not: it is off by a multiple of m_H L / M on an
axis. That pins the port's image fix, a divergence from the JAX package.
"""

import importlib

import networkx as nx
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lammps_analysis_tpu import config as jax_config
from lammps_analysis_tpu.graph import molecular_graph as jmg
from lammps_analysis_tpu.graph import smiles as jsm
from lammps_analysis_tpu.ops import geometry as jgeometry
from lammps_analysis_tpu_torch.graph import molecular_graph as mg
from lammps_analysis_tpu_torch.graph import smiles as sm
from lammps_analysis_tpu_torch.ops import geometry
from lammps_analysis_tpu_torch.transformations import map_molecules
from lammps_analysis_tpu_torch.utils.config import config

import torch_water as tw

torch.set_num_threads(1)

BOX = 3 * 3.1067  # 27 waters at the water box's density
M_WATER = tw.MASSES["O"] + 2 * tw.MASSES["H"]


@pytest.fixture(autouse=True)
def cpu_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    monkeypatch.setattr(jax_config, "native_cpu_kernels", False)


# -------------------------------------------------------------------- SMILES
SMILES = ["[H]O[H]", "O", "C(=O)=O", "CCO", "COC", "c1ccccc1", "[Na+].[Cl-]",
          "CC(=O)O", "C1CC1", "[NH4+]", "F[B-](F)(F)F", "CCCCn1cc[n+](C)c1",
          "CCCCN1C=C[N+](=C1)C"]


@pytest.mark.parametrize("smiles", SMILES)
def test_smiles_composition_and_graph_match_jax(smiles):
    assert sm.smiles_composition(smiles) == jsm.smiles_composition(smiles)
    ours, ref = sm.smiles_graph(smiles), jsm.smiles_graph(smiles)
    assert list(ours.elements) == [ref.nodes[n]["element"] for n in range(ref.number_of_nodes())]
    assert ours.bonds == {(min(a, b), max(a, b)) for a, b in ref.edges}


# ------------------------------------------------------------- the matcher
def _graphs(smiles, add=(), remove=(), seed=0):
    """The SMILES graph with bonds added and removed and its nodes relabelled
    by a seeded permutation, as a port ``MolGraph`` and a networkx graph."""
    g = sm.smiles_graph(smiles)
    edges = (set(g.bonds) | {tuple(sorted(e)) for e in add}) - {tuple(sorted(e)) for e in remove}
    perm = np.random.default_rng(seed).permutation(len(g.elements))
    elements = [None] * len(g.elements)
    for i, e in enumerate(g.elements):
        elements[perm[i]] = e
    edges = [(int(perm[a]), int(perm[b])) for a, b in edges]
    nxg = nx.Graph()
    for i, e in enumerate(elements):
        nxg.add_node(i, element=e)
    nxg.add_edges_from(edges)
    return mg.MolGraph.from_edges(elements, edges), nxg


BMIM = "CCCCn1cc[n+](C)c1"
MATCH_CASES = {
    # id: (cluster SMILES, bonds added, bonds removed, reference SMILES, expected)
    "ethanol-vs-ethanol": ("CCO", (), (), "CCO", True),
    "ethanol-h-h-proximity": ("CCO", [(3, 4), (4, 5), (6, 7)], (), "CCO", True),
    "ethanol-vs-dimethyl-ether": ("CCO", (), (), "COC", False),
    "dimethyl-ether-vs-ethanol": ("COC", (), (), "CCO", False),
    "ethanol-missing-c-o": ("CCO", (), [(1, 2)], "CCO", False),
    "ethanol-with-c-o-and-extra": ("CCO", [(0, 2)], (), "CCO", True),
    "bf4": ("F[B-](F)(F)F", [(0, 2), (2, 3)], (), "F[B-](F)(F)F", True),
    "bf4-missing-b-f": ("F[B-](F)(F)F", [(0, 2)], [(1, 4)], "F[B-](F)(F)F", False),
    "bmim-kekule-reference": (BMIM, (), (), "CCCCN1C=C[N+](=C1)C", True),
    "bmim-proximity-edges": (BMIM, [(0, 2), (9, 11), (12, 13)], (), BMIM, True),
    "bmim-vs-pyrazolium": (BMIM, (), (), "CCCCn1[n+](C)ccc1", False),
    "bmim-c-methyl-isomer": (BMIM, (), (), "CCCCn1cc[nH+]c1C", False),
    "bmim-missing-ring-bond": (BMIM, (), [(5, 6)], BMIM, False),
    "water-triangle": ("[H]O[H]", [(0, 2)], (), "[H]O[H]", True),
    "water-vs-hydrogen-peroxide-size": ("[H]O[H]", (), (), "OO", False),
}


@pytest.mark.parametrize("case", MATCH_CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_matcher_gives_networkx_answer(case, seed):
    cluster, add, remove, reference, expected = MATCH_CASES[case]
    ours, nxg = _graphs(cluster, add, remove, seed)
    got = mg.is_isomorphic_to_reference(ours, sm.smiles_graph(reference))
    ref = jmg.is_isomorphic_to_reference(nxg, jsm.smiles_graph(reference))
    assert got == ref == expected


@settings(max_examples=300, deadline=None)
@given(data=st.data())
def test_matcher_gives_networkx_answer_on_random_graphs(data):
    """Random element-labelled graphs of up to 9 atoms against a relabelled
    copy with bonds added and removed (and, at random, one element
    changed): the port's search and networkx's VF2 monomorphism agree."""
    n = data.draw(st.integers(1, 9))
    elements = data.draw(st.lists(st.sampled_from("CHO"), min_size=n, max_size=n))
    pairs = [(a, b) for a in range(n) for b in range(a + 1, n)]
    bonds = data.draw(st.sets(st.sampled_from(pairs))) if pairs else set()
    extra = data.draw(st.sets(st.sampled_from(pairs))) if pairs else set()
    dropped = data.draw(st.sets(st.sampled_from(sorted(bonds)))) if bonds else set()
    perm = data.draw(st.permutations(range(n)))
    cluster_elements = [None] * n
    for i, e in enumerate(elements):
        cluster_elements[perm[i]] = e
    if data.draw(st.booleans()):
        cluster_elements[0] = data.draw(st.sampled_from("CHO"))
    cluster_edges = [(perm[a], perm[b]) for a, b in (bonds | extra) - dropped]
    ours = mg.is_isomorphic_to_reference(
        mg.MolGraph.from_edges(cluster_elements, cluster_edges),
        mg.MolGraph.from_edges(elements, bonds),
    )
    graph, reference = nx.Graph(), nx.Graph()
    for i in range(n):
        graph.add_node(i, element=cluster_elements[i])
        reference.add_node(i, element=elements[i])
    graph.add_edges_from(cluster_edges)
    reference.add_edges_from(bonds)
    assert ours == jmg.is_isomorphic_to_reference(graph, reference)


GEOMETRIES = {
    # the JAX package's cases (tests/test_molecule_mapping.py): a bent water
    # and an H-H-O chain at 1.2 A; a real water's triangle at 1.7 A
    "bent-water-and-chain": (
        [[0.0, 0.0, 0.0], [0.95, 0.0, 0.0], [-0.3, 0.9, 0.0],
         [10.0, 0.0, 0.0], [10.95, 0.0, 0.0], [11.9, 0.0, 0.0]],
        ["O", "H", "H", "H", "H", "O"], 1.2, [True, False],
    ),
    "water-triangle": (
        [[0.0, 0.0, 0.0], [0.96, 0.0, 0.0], [-0.24, 0.93, 0.0]], ["O", "H", "H"], 1.7, [True],
    ),
}


@pytest.mark.parametrize("case", GEOMETRIES)
def test_clusters_from_positions_match_jax(case):
    pos, species, cutoff, expected = GEOMETRIES[case]
    pos = np.asarray(pos)
    adj, jadj = mg.build_adjacency(pos, None, cutoff), jmg.build_adjacency(pos, None, cutoff)
    assert (adj != jadj).nnz == 0
    mols, ids = mg.find_molecules(adj, species, return_atom_ids=True)
    assert (mols, ids) == tuple(jmg.find_molecules(jadj, species, return_atom_ids=True))
    reference = "[H]O[H]"
    verdicts = []
    for atom_ids in ids:
        g, jg = mg.cluster_graph(adj, atom_ids, species), jmg.cluster_graph(jadj, atom_ids, species)
        assert g.bonds == {(min(a, b), max(a, b)) for a, b in jg.edges}
        got = mg.is_isomorphic_to_reference(g, sm.smiles_graph(reference))
        assert got == jmg.is_isomorphic_to_reference(jg, jsm.smiles_graph(reference))
        verdicts.append(got)
    assert verdicts == expected


# ------------------------------------------------------- adjacency, groups
@pytest.mark.parametrize("box", [12.0, None])
@pytest.mark.parametrize("seed", [3, 4])
def test_build_adjacency_and_find_molecules_match_jax(box, seed):
    """Random float64 positions: the same CSR and the same groups. The box
    is float32-representable, so the port's float32 reciprocal and the JAX
    package's division pick the same images."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, 12.0, (300, 3))
    species = ["O"] * 100 + ["H"] * 200
    box = None if box is None else np.full(3, box)
    adj = mg.build_adjacency(pos, box, 1.3, chunk=64)
    jadj = jmg.build_adjacency(pos, box, 1.3, chunk=64)
    assert adj.nnz > 0 and adj.shape == jadj.shape and (adj != jadj).nnz == 0
    assert mg.find_molecules(adj, species) == jmg.find_molecules(jadj, species)
    assert mg.group_molecules_by_composition(mg.find_molecules(adj, species)) == \
        jmg.group_molecules_by_composition(jmg.find_molecules(jadj, species))


def test_adjacency_of_float32_water_matches_jax():
    """The float32 store's first frame against the JAX package in float64:
    bonds (1.0 and 1.633 A) and the first frame's clearance (2 A) lie far
    from the 1.7 A cutoff, so the edge sets are equal."""
    w = tw.water_box(3, 1, BOX, 0.1, seed=5)
    pos = w["wrapped"][0]
    adj = mg.build_adjacency(pos.astype(np.float32), np.full(3, BOX), 1.7)
    jadj = jmg.build_adjacency(pos, np.full(3, BOX), 1.7)
    assert adj.nnz == 27 * 6 and (adj != jadj).nnz == 0


@pytest.mark.parametrize("center", [False, True])
def test_wrap_coordinates_matches_jax(center):
    rng = np.random.default_rng(6)
    pos = rng.uniform(-30.0, 30.0, (50, 3))
    box = np.array([9.0, 10.0, 11.0])
    ours = geometry.wrap_coordinates(torch.from_numpy(pos), torch.from_numpy(box), center)
    ref = np.asarray(jgeometry.wrap_coordinates(pos, box, center))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-12)


# ------------------------------------------------------------ MolecularMap
def _experiment(package, root, positions, box, order=("O", "H"), prop="Positions",
                n_mol=None, rows=None):
    """A ``package`` Project under ``root``: one experiment ``w`` of waters in
    GROMACS order (``positions`` (T, 3 n_mol, 3)), species in ``order``."""
    pkg = importlib.import_module(package)
    planner = importlib.import_module(package + ".memory.planner")
    project = pkg.Project(name="water", storage_path=root)
    exp = project.add_experiment(
        "w", timestep=0.002, temperature=300.0, units="metal",
        simulation_data=_script_input(package, positions, box, order, prop, n_mol, rows),
    )
    exp.planner = planner.BatchPlanner(memory_budget_bytes=2**33)
    return exp


def _script_input(package, positions, box, order=("O", "H"), prop="Positions",
                  n_mol=None, rows=None, name="water"):
    """The ``package`` ``ScriptInput`` of ``_experiment``'s frames."""
    db = importlib.import_module(package + ".database")
    props = importlib.import_module(package + ".database.properties")
    file_io = importlib.import_module(package + ".file_io")
    n_frames = positions.shape[0]
    n_mol = positions.shape[1] // 3 if n_mol is None else n_mol
    rows = tw.species_rows(n_mol) if rows is None else rows
    p = props.PropertyInfo(prop, 3)
    species = [db.SpeciesInfo(sp, len(rows[sp]), [p]) for sp in order]
    meta = db.TrajectoryMetadata(
        n_configurations=n_frames, species_list=species, box_l=[box] * 3, sample_rate=1,
    )
    chunk = db.TrajectoryChunkData(species, n_frames)
    for sp in order:
        chunk.add_data(positions[:, rows[sp]], 0, sp, prop)
    return file_io.ScriptInput(chunk, meta, name)


def _map(exp, package, **kw):
    pkg = importlib.import_module(package)
    kw = {"smiles": "[H]O[H]", "cutoff": 1.7, **kw}
    exp.run.MolecularMap(molecules=[pkg.Molecule(name="water", **kw)])
    return exp.load_matrix("Unwrapped_Positions", ["water"])["water"]


def _offset_from(com, truth, box):
    """``com - truth`` less the whole box vector it has at the first frame
    (the image of the molecule's first atom)."""
    d = com - truth
    return d - box * np.round(d[:1] / box)


@pytest.mark.parametrize("ref_idx", [0, 7])
def test_molecular_map_matches_jax_on_whole_molecules(tmp_path, ref_idx):
    w = tw.water_box(3, 20, BOX, 0.02, seed=11, rotation_sd=0.01, straddle=False)
    assert w["straddling"] == 0
    ours = _experiment("lammps_analysis_tpu_torch", tmp_path / "torch", w["wrapped"], BOX)
    ref = _experiment("lammps_analysis_tpu", tmp_path / "jax", w["wrapped"], BOX)
    com = _map(ours, "lammps_analysis_tpu_torch", amount=27, reference_configuration_idx=ref_idx)
    jcom = _map(ref, "lammps_analysis_tpu", amount=27, reference_configuration_idx=ref_idx)
    assert com.dtype == np.float32 and com.shape == (20, 27, 3)
    np.testing.assert_allclose(com, jcom, rtol=0, atol=1e-4)
    np.testing.assert_allclose(com, w["com"], rtol=0, atol=1e-4)
    wrapped = ours.load_matrix("Positions", ["water"])["water"]
    np.testing.assert_allclose(wrapped, ref.load_matrix("Positions", ["water"])["water"],
                               rtol=0, atol=1e-4)
    assert wrapped.min() >= 0 and (wrapped < np.float32(BOX)).all()
    assert ours.molecules == ref.molecules
    assert ours.molecules["water"]["n_particles"] == 27
    assert set(ours.store.species_names()) == set(ref.store.species_names())


@pytest.mark.parametrize("order", [("O", "H"), ("H", "O")])
@pytest.mark.parametrize("ref_idx", [0, 7])
def test_straddling_molecules_get_the_true_com(tmp_path, order, ref_idx):
    """Molecules across a face at the first frame: the port's COM is the
    true one (less the whole box vector of the first atom's image), the JAX
    package's is off by a multiple of m_H L / M on an axis (the image fix is
    taken at frame 0 whatever the reference frame). Both find the same
    groups."""
    w = tw.water_box(3, 20, BOX, 0.02, seed=12, rotation_sd=0.01)
    assert w["straddling"] >= 3
    ours = _experiment("lammps_analysis_tpu_torch", tmp_path / "torch", w["wrapped"], BOX, order)
    ref = _experiment("lammps_analysis_tpu", tmp_path / "jax", w["wrapped"], BOX, order)
    com = _map(ours, "lammps_analysis_tpu_torch", reference_configuration_idx=ref_idx)
    jcom = _map(ref, "lammps_analysis_tpu", reference_configuration_idx=ref_idx)
    assert ours.molecules == ref.molecules
    assert ours.molecules["water"]["n_particles"] == 27
    # molecule m of the record is molecule m of the generator: groups follow
    # the first species' atom order, which is the grid order
    np.testing.assert_allclose(_offset_from(com, w["com"], BOX), 0.0, atol=1e-4)
    jerr = _offset_from(jcom, w["com"], BOX)[0]  # constant over the frames
    images = np.floor(w["unwrapped"][0] / BOX).reshape(27, 3, 3)
    straddles = (images != images[:, :1]).any(axis=(1, 2))
    np.testing.assert_allclose(jerr[~straddles], 0.0, atol=1e-4)
    unit = tw.MASSES["H"] * BOX / M_WATER
    steps = jerr[straddles] / unit
    np.testing.assert_allclose(steps, np.rint(steps), atol=1e-3)
    assert (np.abs(np.rint(steps)).max(axis=1) >= 1).all()
    assert np.isclose(np.abs(jerr[straddles]), unit, atol=1e-4).any()


def test_mapping_is_idempotent(tmp_path, monkeypatch):
    w = tw.water_box(3, 10, BOX, 0.1, seed=13)
    exp = _experiment("lammps_analysis_tpu_torch", tmp_path, w["wrapped"], BOX)
    _map(exp, "lammps_analysis_tpu_torch", species_dict={"O": 1, "H": 2}, smiles=None)
    cursor = exp.store.get_cursor("water/Unwrapped_Positions")
    calls = []
    original = map_molecules.com_batch
    monkeypatch.setattr(map_molecules, "com_batch", lambda *a: calls.append(1) or original(*a))
    _map(exp, "lammps_analysis_tpu_torch", species_dict={"O": 1, "H": 2}, smiles=None)
    assert exp.store.get_cursor("water/Unwrapped_Positions") == cursor == 10
    assert calls == []


def test_mapping_extends_after_an_append(tmp_path):
    """Map 12 frames, append 8, map again: the atoms' unwrap and the
    molecule's datasets are extended to 20 frames, equal to one map over all
    20 and to the generator's COM (the JAX package leaves the atoms' unwrap
    at 12 frames and maps the new frames from its unwritten rows, zeros)."""
    torch_pkg = "lammps_analysis_tpu_torch"
    w = tw.water_box(3, 20, BOX, 0.1, seed=15)
    assert w["straddling"] >= 1
    exp = _experiment(torch_pkg, tmp_path / "two", w["wrapped"][:12], BOX)
    _map(exp, torch_pkg, amount=27)
    assert exp.store.get_cursor("water/Unwrapped_Positions") == 12
    exp.add_data(_script_input(torch_pkg, w["wrapped"][12:], BOX, name="water-2"))
    com = _map(exp, torch_pkg, amount=27)
    assert exp.store.get_cursor("O/Unwrapped_Positions") == 20
    assert exp.store.get_cursor("water/Positions") == 20
    whole = _experiment(torch_pkg, tmp_path / "one", w["wrapped"], BOX)
    np.testing.assert_array_equal(com, _map(whole, torch_pkg, amount=27))
    for prop in ("Positions", "Unwrapped_Positions"):
        np.testing.assert_array_equal(exp.load_matrix(prop, ["O", "H", "water"])["water"],
                                      whole.load_matrix(prop, ["O", "H", "water"])["water"])
    assert exp.molecules == whole.molecules
    np.testing.assert_allclose(_offset_from(com, w["com"], BOX), 0.0, atol=1e-4)

    ref = _experiment("lammps_analysis_tpu", tmp_path / "jax", w["wrapped"][:12], BOX)
    _map(ref, "lammps_analysis_tpu", amount=27)
    ref.add_data(_script_input("lammps_analysis_tpu", w["wrapped"][12:], BOX, name="water-2"))
    jcom = _map(ref, "lammps_analysis_tpu", amount=27)
    assert ref.store.get_cursor("O/Unwrapped_Positions") == 12
    assert jcom[:12].all() and not jcom[12:].any()


def test_species_dict_groups_match_jax(tmp_path):
    w = tw.water_box(3, 6, BOX, 0.1, seed=14)
    ours = _experiment("lammps_analysis_tpu_torch", tmp_path / "torch", w["wrapped"], BOX)
    ref = _experiment("lammps_analysis_tpu", tmp_path / "jax", w["wrapped"], BOX)
    kw = dict(species_dict={"O": 1, "H": 2}, smiles=None, cutoff=1.2, amount=27)
    _map(ours, "lammps_analysis_tpu_torch", **kw)
    _map(ref, "lammps_analysis_tpu", **kw)
    assert ours.molecules == ref.molecules


@pytest.mark.parametrize("package", ["lammps_analysis_tpu_torch", "lammps_analysis_tpu"])
@pytest.mark.parametrize("spec, match", [
    (dict(species_dict={"Na": 1, "Cl": 1}, cutoff=2.0), "needs species"),
    (dict(species_dict={"O": 2}, cutoff=0.1), "No molecules matching"),
    (dict(cutoff=1.2), "needs either smiles or species_dict"),
])
def test_bad_molecule_specs_raise_alike(tmp_path, package, spec, match):
    w = tw.water_box(3, 4, BOX, 0.1, seed=15)
    exp = _experiment(package, tmp_path, w["wrapped"], BOX)
    pkg = importlib.import_module(package)
    with pytest.raises(ValueError, match=match):
        exp.run.MolecularMap(molecules=[pkg.Molecule(name="bad", **spec)])
    with pytest.raises(ValueError, match="needs a list"):
        exp.run.MolecularMap(molecules=[])


def test_misbonded_cluster_is_rejected_as_in_jax(tmp_path, caplog):
    """The JAX package's case: one water and an H-H-O chain of the same
    composition; only the water is accepted."""
    o = np.array([[2.0, 2.0, 2.0], [12.9, 2.0, 2.0]])
    h = np.array([[2.95, 2.0, 2.0], [1.7, 2.9, 2.0], [11.0, 2.0, 2.0], [11.95, 2.0, 2.0]])
    pos = np.repeat(np.concatenate([o, h])[None], 4, axis=0)
    rows = {"O": [0, 1], "H": [2, 3, 4, 5]}
    records = []
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _experiment(package, tmp_path / package, pos, 20.0, n_mol=2, rows=rows)
        _map(exp, package, smiles="O", cutoff=1.2, amount=1)
        records.append(exp.molecules)
    assert records[0] == records[1]
    assert records[0]["water"]["n_particles"] == 1
    assert "rejected 1 same-composition cluster" in caplog.text


def test_unwrapped_only_store_matches_jax(tmp_path):
    """A store of ``Unwrapped_Positions`` alone: groups detected on them
    under the minimum image, the 1.7 A cutoff's triangles accepted."""
    w = tw.water_box(3, 10, BOX, 0.1, seed=16, straddle=False)
    kw = dict(prop="Unwrapped_Positions")
    ours = _experiment("lammps_analysis_tpu_torch", tmp_path / "torch", w["unwrapped"], BOX, **kw)
    ref = _experiment("lammps_analysis_tpu", tmp_path / "jax", w["unwrapped"], BOX, **kw)
    com = _map(ours, "lammps_analysis_tpu_torch", amount=27)
    jcom = _map(ref, "lammps_analysis_tpu", amount=27)
    assert ours.molecules == ref.molecules
    np.testing.assert_allclose(com, jcom, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["gro", "trr"])
def test_groups_from_a_gromacs_file_match_jax(tmp_path, kind):
    """The same GROMACS file (rows OW HW1 HW2 per molecule, so each species'
    rows interleave with the other's) through both packages' readers and
    ``MolecularMap``: the same ``groups`` (the same scipy labels of the same
    adjacency) and, for these whole molecules, the same COM."""
    import lammps_analysis_tpu as latpu
    import lammps_analysis_tpu_torch as lt

    w = tw.water_box(3, 8, BOX, 0.05, seed=17, straddle=False)
    path = tmp_path / f"w.{kind}"
    if kind == "gro":
        tw.write_gro(path, w["wrapped"], BOX)
    else:
        tw.write_trr(path, BOX, x=w["wrapped"])
    coms, records = [], []
    for pkg in (lt, latpu):
        file_io = importlib.import_module(pkg.__name__ + ".file_io")
        data = str(path) if kind == "gro" else file_io.TRRFile(path, species=tw.species_rows(27))
        exp = pkg.Project(name="p", storage_path=tmp_path / pkg.__name__).add_experiment(
            "w", timestep=0.002, units="metal", simulation_data=data)
        exp.run.MolecularMap(molecules=[pkg.Molecule("water", smiles="[H]O[H]", amount=27, cutoff=1.7)])
        coms.append(exp.load_matrix("Unwrapped_Positions", ["water"])["water"])
        records.append(exp.molecules)
    assert records[0] == records[1] and records[0]["water"]["n_particles"] == 27
    np.testing.assert_allclose(coms[0], coms[1], rtol=0, atol=1e-4)


# -------------------------------------------------------- the water workflow
def test_water_study_workflow_matches_jax(tmp_path):
    """``tests/test_water_workflow.py``'s study on both packages: mapping,
    molecular Einstein diffusion, molecular RDF and the atomistic ADF with
    its H-O-H peak. The inputs are float32-representable, so both stores
    hold the same atoms; the port stores the COM in float32 and the JAX
    package in float64, so the RDF may move a pair across a bin edge (at
    most 4 bins differ) and the Einstein outputs agree within rtol 1e-4 (the
    float32 COM moves its fit errors by ~1.2e-5, past the transport rtol)."""
    rng = np.random.default_rng(42)
    n_mol, t, box = 12, 60, 16.0
    grid = np.array([[2.5 + 4.0 * (i % 3), 2.5 + 4.0 * ((i // 3) % 3), 2.5 + 4.0 * (i // 9)]
                     for i in range(n_mol)])
    o = grid[None] + np.cumsum(0.02 * rng.standard_normal((t, n_mol, 3)), axis=0)
    h1 = o + np.array([0.96, 0.0, 0.0]) + 0.005 * rng.standard_normal((t, n_mol, 3))
    h2 = o + np.array([-0.24, 0.93, 0.0]) + 0.005 * rng.standard_normal((t, n_mol, 3))
    pos = np.stack([o, h1, h2], axis=2).reshape(t, 3 * n_mol, 3).astype(np.float32).astype(np.float64)
    angle_built = np.degrees(np.arccos(
        np.dot([0.96, 0.0, 0.0], [-0.24, 0.93, 0.0]) / (0.96 * np.hypot(0.24, 0.93))
    ))
    results = {}
    for package in ("lammps_analysis_tpu_torch", "lammps_analysis_tpu"):
        exp = _experiment(package, tmp_path / package, pos, box, prop="Unwrapped_Positions")
        _map(exp, package, amount=n_mol)
        assert exp.molecules["water"]["n_particles"] == n_mol
        results[package] = dict(
            d=exp.run.EinsteinDiffusionCoefficients(
                molecules=True, data_range=30, correlation_time=15, plot=False),
            rdf=exp.run.RadialDistributionFunction(
                molecules=True, number_of_configurations=5, plot=False),
            adf=exp.run.AngularDistributionFunction(
                number_of_configurations=3, cutoff=1.2, number_of_bins=90, plot=False),
            molecules=exp.molecules,
        )
    ours, ref = results["lammps_analysis_tpu_torch"], results["lammps_analysis_tpu"]
    assert ours["molecules"] == ref["molecules"]
    assert set(ours["d"].data_dict) == {"water"}
    for key, value in ref["d"]["water"].items():
        np.testing.assert_allclose(ours["d"]["water"][key], value, rtol=1e-4, err_msg=key)
    assert sorted(ours["rdf"].data_dict) == ["water_water"]
    np.testing.assert_allclose(ours["rdf"]["water_water"]["x"], ref["rdf"]["water_water"]["x"], rtol=1e-12)
    y, jy = np.asarray(ours["rdf"]["water_water"]["y"]), np.asarray(ref["rdf"]["water_water"]["y"])
    assert y.sum() > 0 and (~np.isclose(y, jy, rtol=1e-6)).sum() <= 4
    for key in ref["adf"].data_dict:
        adf, jadf = np.asarray(ours["adf"][key]["adf"]), np.asarray(ref["adf"][key]["adf"])
        np.testing.assert_allclose(adf.sum(), jadf.sum(), rtol=1e-5)
        assert (~np.isclose(adf, jadf, rtol=1e-4, atol=1e-6)).sum() <= 2
    peak = ours["adf"]["O_H_H"]["max_peak"]
    assert peak == ref["adf"]["O_H_H"]["max_peak"]
    assert abs(peak - angle_built) < 4.0, (peak, angle_built)
