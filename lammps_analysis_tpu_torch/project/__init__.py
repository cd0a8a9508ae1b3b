"""Projects: directory-rooted collections of experiments."""
from .project import Project  # noqa: F401
