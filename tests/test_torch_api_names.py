"""Name census: every public name of the JAX package has its place in the port.

An AST walk of both packages, with no import of either, so it runs in any
process. For every module of ``lammps_analysis_tpu`` its public names are the
module-level functions and classes, the public methods of its public classes
(``Class.method``), its ``__all__``, and for an ``__init__`` the names it
imports. Each must have one of:

(a) the same name at the same module path in the port (defined, imported or
    in ``__all__`` there; a method may come from a base class of the port's);
(b) an entry in ``RENAMED``: the port name that takes its place, which must
    resolve in the port's AST;
(c) an entry in ``NOT_PORTED`` with its one-line reason (ROADMAP Queue 1
    item 10: what exists only for the TPU, or only as a route or an A/B arm).

One case per JAX module; a last case proves the check fails when a name is
removed from a copy of the port.
"""

from __future__ import annotations

import ast
import functools
import pathlib
import shutil

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX = REPO / "lammps_analysis_tpu"
PORT = REPO / "lammps_analysis_tpu_torch"

# (b) JAX "module::name" -> the port's "module::name" that takes its place
RENAMED = {
    "ops/__init__.py::minimum_image": "ops/__init__.py::minimum_image_divided",
    "ops/rdf.py::rdf_histogram": "ops/rdf_kernel.py::rdf_histogram",
    "ops/adf.py::adf_histogram": "ops/adf_kernel.py::adf_histogram",
    "ops/adf.py::adf_histogram_neighbors": "ops/adf.py::adf_histogram_reference",
    "ops/adf.py::adf_histogram_tiled": "ops/adf.py::adf_histogram_reference",
    "ops/adf.py::adf_pairs_histogram_xla": "ops/adf.py::adf_pairs_histogram_reference",
    "ops/cells.py::cells_per_dim": "ops/cells.py::cells_per_axis",
    "ops/cells.py::build_cell_table": "ops/cells.py::cell_of_atoms",
    "ops/cells.py::neighbor_cell_offsets": "ops/cells.py::neighbor_cells",
    "ops/cells.py::candidate_table": "ops/adf_kernel.py::neighbor_extract_binned",
    "ops/cells.py::neighbor_lists_cells": "ops/adf_kernel.py::neighbor_extract_binned",
    "ops/histogram.py::masked_histogram_scatter": "ops/histogram.py::masked_histogram",
    "ops/pallas_rdf.py::rdf_histogram_pallas": "ops/rdf_kernel.py::rdf_histogram",
    "ops/pallas_adf.py::adf_histogram_pallas": "ops/adf_kernel.py::adf_histogram",
    "ops/pallas_adf.py::adf_neighbor_lists": "ops/adf_kernel.py::neighbor_lists",
    "ops/pallas_adf.py::pallas_neighbor_lists": "ops/adf_kernel.py::neighbor_lists",
    "ops/pallas_adf.py::pallas_neighbor_components": "ops/adf_kernel.py::neighbor_components",
    "ops/pallas_adf.py::neighbor_indices_pallas": "ops/adf_kernel.py::neighbor_indices",
    "ops/pallas_adf.py::auto_neighbor_lists": "ops/adf_kernel.py::neighbor_extract",
    "ops/pallas_adf.py::adf_pairs_histogram_pallas": "ops/adf_kernel.py::adf_pairs_histogram",
    "ops/pallas_adf.py::adf_stage2_auto": "ops/adf_kernel.py::adf_pairs_histogram",
    "ops/pallas_adf.py::sorted_neighbor_extract": "ops/adf_kernel.py::sorted_neighbor_extract",
    "ops/pallas_adf.py::sorted_neighbor_extract_stripe": "ops/adf_kernel.py::neighbor_extract",
    "ops/pallas_adf.py::window_chunk_bound": "ops/sorting.py::window_chunk_bound",
    "ops/pallas_adf.py::brick_window_bound": "ops/sorting.py::brick_window_bound",
    # the port's base has no carry default: each transformation that carries
    # state across an append defines its own
    "transformations/base.py::Transformation.bootstrap_carry":
        "transformations/coordinate_transforms.py::CoordinateUnwrapper.bootstrap_carry",
    "transformations/base.py::Transformation.bootstrap_carry_multi":
        "transformations/flux_transforms.py::KinaciIntegratedHeatCurrent.bootstrap_carry_multi",
}

_STRATEGY = "a histogram strategy for the TPU; every strategy name gives masked_histogram's scatter"
_NATIVE = "a native CPU route; the port's CPU path is its plain torch version (chip_smoke.py times the kernel as a bar)"
_HOST_ROUTE = "the flux transformations' numpy host route for the TPU link; the port runs transform_batch on config.device"
_DEVICES = "the TPU link's probe and host-routing policy"
_CACHE = "XLA's persistent compile cache; the port runs eagerly and builds its kernels once per checkout"
# (c) JAX "module::name" -> why the port has no counterpart (ROADMAP item 10)
NOT_PORTED = {
    "__init__.py::enable_persistent_compile_cache": _CACHE,
    "utils/config.py::enable_persistent_compile_cache": _CACHE,
    "ops/histogram.py::default_strategy": _STRATEGY,
    "ops/histogram.py::masked_histogram_compare": _STRATEGY,
    "ops/histogram.py::masked_histogram_outer": _STRATEGY,
    "ops/msd.py::windowed_msd_gram_sum": "an MXU Gram-matrix form of windowed_msd_sum for the TPU; same sums",
    "ops/native_rdf.py::available": _NATIVE,
    "ops/native_rdf.py::rdf_histogram_native": _NATIVE,
    "ops/native_rdf.py::species_segments": _NATIVE,
    "ops/native_adf.py::available": _NATIVE,
    "ops/native_adf.py::adf_histogram_native": _NATIVE,
    "ops/native_sdf.py::available": _NATIVE,
    "ops/native_sdf.py::sdf_histogram_native": _NATIVE,
    "ops/pallas_rdf.py::padded_atom_count": "the TPU kernel's lane padding; K1 takes any atom count",
    "ops/pallas_adf.py::acos_f32": "the TPU kernel's arccos polynomial; K3 calls acosf",
    "ops/pallas_adf.py::extract_e_for": "the TPU kernel's per-chunk extraction depth into VMEM",
    "ops/pallas_adf.py::brick3_window_bound": "the opt-in brick3 sort, a TPU A/B arm",
    "parallel/sharded_ops.py::rdf_use_pallas": "the Pallas-or-XLA route choice; the card always runs K1",
    "parallel/sharded_ops.py::pallas_rdf_frames_per_call": "the TPU kernel's VMEM frame budget",
    "parallel/sharded_ops.py::adf_frames_per_call": "the TPU kernel's VMEM frame budget",
    "parallel/sharded_ops.py::rdf_use_native": _NATIVE,
    "parallel/sharded_ops.py::adf_use_native": _NATIVE,
    "utils/devices.py::bandwidth_bound_compute": _DEVICES,
    "utils/devices.py::bandwidth_bound_device": _DEVICES,
    "utils/devices.py::device_transfer_bandwidth_mbps": _DEVICES,
    "utils/devices.py::reset_measurement": _DEVICES,
    **{f"utils/profiling.py::{name}": "host timers nothing reads; the port's spans time every layer"
       for name in ("Stopwatch", "Stopwatch.section", "Stopwatch.report", "Stopwatch.throughput")},
    **{f"transformations/flux_transforms.py::{cls}.transform_batch_host": _HOST_ROUTE
       for cls in ("IonicCurrent", "TranslationalDipoleMoment", "ThermalFlux",
                   "IntegratedHeatCurrent", "KinaciIntegratedHeatCurrent", "MomentumFlux")},
}


@functools.lru_cache(maxsize=None)
def _parse(text: str) -> ast.Module:
    return ast.parse(text)


def _tree(path: pathlib.Path) -> ast.Module | None:
    return _parse(path.read_text()) if path.exists() else None


def _public(name: str) -> bool:
    return not name.startswith("_")


def public_names(path: pathlib.Path) -> set[str]:
    """The public names of one module, as the census counts them."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)) and _public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{sub.name}" for sub in node.body
                           if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                           and _public(sub.name))
        elif isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets
        ):
            out.update(elt.value for elt in node.value.elts)
        elif isinstance(node, ast.ImportFrom) and path.name == "__init__.py":
            out.update(n for a in node.names if _public(n := a.asname or a.name) and n != "annotations")
    return out


def _module_names(tree: ast.Module) -> set[str]:
    """Every name a module binds at its top level, imports and ``__all__``."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                    if t.id == "__all__":
                        out.update(elt.value for elt in node.value.elts)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


@functools.lru_cache(maxsize=None)
def _classes(root: pathlib.Path) -> dict:
    """Class name -> [(module, ClassDef)] over every module under ``root``
    (read once a root)."""
    index: dict = {}
    for path in sorted(root.rglob("*.py")):
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.ClassDef):
                index.setdefault(node.name, []).append((path, node))
    return index


def _has_method(cls: ast.ClassDef, method: str, index: dict, seen=()) -> bool:
    for sub in cls.body:
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and sub.name == method:
            return True
        if isinstance(sub, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == method for t in sub.targets
        ):
            return True
    for base in cls.bases:
        name = base.id if isinstance(base, ast.Name) else getattr(base, "attr", None)
        for _, node in index.get(name, []):
            if node not in seen and _has_method(node, method, index, seen + (cls,)):
                return True
    return False


def resolves(port_root: pathlib.Path, module: str, name: str) -> bool:
    """Whether ``name`` (``func``, ``Class`` or ``Class.method``) is at
    ``module`` of the port under ``port_root``."""
    tree = _tree(port_root / module)
    if tree is None:
        return False
    if "." not in name:
        return name in _module_names(tree)
    cls_name, method = name.split(".", 1)
    index = _classes(port_root)
    here = [node for path, node in index.get(cls_name, []) if path == port_root / module]
    if not here and cls_name not in _module_names(tree):
        return False
    return any(_has_method(node, method, index) for node in here or
               [node for _, node in index.get(cls_name, [])])


def missing_names(module: str, port_root: pathlib.Path = PORT) -> list[str]:
    """The public names of JAX ``module`` that meet none of (a), (b), (c)."""
    missing = []
    for name in sorted(public_names(JAX / module)):
        key = f"{module}::{name}"
        if key in NOT_PORTED:
            continue
        if key in RENAMED:
            target_module, target = RENAMED[key].split("::")
            if not resolves(port_root, target_module, target):
                missing.append(f"{key} (mapped to {RENAMED[key]}, which is not in the port)")
            continue
        if not resolves(port_root, module, name):
            missing.append(key)
    return missing


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_has_its_place_in_the_port(module):
    assert missing_names(module) == []
    # an entry of the maps names a public JAX name the port does not have as it is
    for key in [k for k in (*RENAMED, *NOT_PORTED) if k.split("::")[0] == module]:
        name = key.split("::")[1]
        assert name in public_names(JAX / module), f"{key} is no public JAX name"
        assert not resolves(PORT, module, name), f"{key} is in the port as it is: drop its entry"
        assert key not in RENAMED or key not in NOT_PORTED
    for reason in NOT_PORTED.values():
        assert reason and "\n" not in reason


def test_the_census_fails_when_a_name_is_removed(tmp_path):
    intact, copy = tmp_path / "intact", tmp_path / "port"
    for root in (intact, copy):
        shutil.copytree(PORT, root, ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so"))
    for module in ("ops/correlation.py", "database/trajectory_store.py", "ops/cells.py"):
        assert missing_names(module, intact) == []
    source = copy / "ops" / "correlation.py"
    source.write_text(source.read_text().replace("def acf_biased(", "def acf_biased_gone("))
    store = copy / "database" / "trajectory_store.py"
    store.write_text(store.read_text().replace("def summary(", "def summary_gone("))
    assert missing_names("ops/correlation.py", copy) == ["ops/correlation.py::acf_biased"]
    assert missing_names("database/trajectory_store.py", copy) == [
        "database/trajectory_store.py::TrajectoryStore.summary"
    ]
    # a mapped name whose target went is caught too
    cells = copy / "ops" / "cells.py"
    cells.write_text(cells.read_text().replace("def cells_per_axis(", "def cells_per_axis_gone("))
    assert any(m.startswith("ops/cells.py::cells_per_dim") for m in missing_names("ops/cells.py", copy))
