"""Trajectory sources. This slice ingests in memory through ``ScriptInput``;
the file readers of the JAX package are not ported yet."""
from .base import FileProcessor, assert_species_list_consistent  # noqa: F401
from .script_input import ScriptInput  # noqa: F401
