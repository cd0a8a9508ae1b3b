"""Framework-wide constants and exception types.

Copied from ``lammps_analysis_tpu/utils/constants.py``, which re-expresses
MDSuite's ``mdsuite/utils/constants.py`` and ``mdsuite/utils/exceptions.py``.
"""

from __future__ import annotations


class DatasetKeys:
    """Special group names inside the trajectory store.

    ``OBSERVABLES`` holds system-wide (non-per-atom) time series such as the
    ionic current or thermal flux (reference: ``utils/constants.py:38``).
    """

    OBSERVABLES = "Observables"


GROUP_METADATA = "_metadata"


# --- exceptions -------------------------------------------------------------------
class MDSuiteTPUError(Exception):
    """Base class for framework errors."""


class NoElementInDumpError(MDSuiteTPUError):
    """Raised when a trajectory file has neither element nor type columns."""


class ElementMassAssignedZeroError(MDSuiteTPUError):
    """Raised when an element could not be assigned a mass."""


class CannotFindPropertyError(MDSuiteTPUError):
    """Raised when a requested property is not in the store and cannot be derived."""


class DatabaseDoesNotExistError(MDSuiteTPUError):
    """Raised when an operation requires an existing store that is absent."""


class ComputationNotCachedError(MDSuiteTPUError):
    """Raised internally when a computation is not present in the results DB."""


class DataRangeError(MDSuiteTPUError):
    """Raised when data_range exceeds the available configurations."""


class NotApplicableToAnalysisError(MDSuiteTPUError):
    """Raised when a calculator option combination is invalid."""


class SpeciesNotFoundError(MDSuiteTPUError):
    """Raised when a species name is not registered in the experiment."""
