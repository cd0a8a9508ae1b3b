"""The PyTorch port imports neither jax nor the JAX package, nor networkx.

An AST walk over every module of ``lammps_analysis_tpu_torch``. It reads the
sources rather than ``sys.modules``: other code in the test process may
import jax first.
"""

import ast
import pathlib

import pytest
import torch

torch.set_num_threads(1)

PORT = pathlib.Path(__file__).resolve().parent.parent / "lammps_analysis_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py"))


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in ("jax", "jaxlib", "lammps_analysis_tpu", "networkx")


def _imports(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "import_module"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value


def test_port_has_sources():
    assert len(SOURCES) > 20
    for kernel in ("rdf_histogram", "adf_neighbor_extract", "adf_neighbor_cells", "adf_pairs_histogram"):
        assert (PORT / "csrc" / f"{kernel}.cu").exists()
    for package, modules in {
        "file_io": ("native_parser", "tabular", "lammps_dump", "lammps_flux", "extxyz", "gro",
                    "trr", "dcd", "chemfiles_io", "chemfiles_read"),
        "transformations": ("base", "coordinate_transforms", "flux_transforms", "registry",
                            "map_molecules"),
        "graph": ("molecular_graph", "smiles"),
        "utils": ("molecule",),
        "ops": ("msd", "correlation", "geometry"),
        "calculators": ("einstein_diffusion_coefficients", "green_kubo_diffusion_coefficients",
                        "post_processing", "system_calculators"),
        "data": ("form_factors",),
    }.items():
        for module in modules:
            assert PORT / package / f"{module}.py" in SOURCES, (package, module)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PORT)))
def test_module_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imports(tree) if _forbidden(name)]
    assert not bad, bad


def test_the_check_catches_a_jax_import():
    tree = ast.parse(
        "import os\nimport jax.numpy as jnp\nfrom lammps_analysis_tpu.ops import rdf\n"
        "from .ops import rdf_kernel\nimport importlib\nimportlib.import_module('jax')\n"
        "import networkx as nx\n"
    )
    assert [name for _, name in _imports(tree) if _forbidden(name)] == [
        "jax.numpy", "lammps_analysis_tpu.ops", "networkx", "jax",
    ]
