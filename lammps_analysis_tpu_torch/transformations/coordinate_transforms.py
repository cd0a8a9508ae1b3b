"""Coordinate-space transformations (unwrap / wrap / scale / velocities).

Counterpart of ``lammps_analysis_tpu/transformations/coordinate_transforms.py``
in torch ops on the ``(time, atoms, 3)`` layout, with explicit carries:

* ``CoordinateUnwrapper``  (reference ``unwrap_coordinates.py:35-81``)
* ``UnwrapViaIndices``     (``unwrap_via_indices.py:40-60``)
* ``CoordinateWrapper``    (``wrap_coordinates.py:51-80``)
* ``ScaleCoordinates``     (``scale_coordinates.py:40-55``)
* ``VelocityFromPositions``(``velocity_from_positions.py:33-59``)

The JAX package's ``time_cumsum`` is ``torch.cumsum``; ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..database.properties import mdsuite_properties as mp
from ..database.trajectory_store import join_path
from ..ops.geometry import wrap_coordinates
from ..utils.config import get_device
from .base import Transformation


class CoordinateUnwrapper(Transformation):
    """Remove periodic-boundary jumps by integrating image crossings.

    The carry holds the previous batch's last positions and image counts so
    batches of any size chain exactly (the reference's carry dict,
    ``unwrap_coordinates.py:56-66``).
    """

    input_properties = [mp.positions, mp.box_length]
    output_property = mp.unwrapped_positions
    scale_function = {"linear": {"scale_factor": 2}}
    requires_carryover = True

    def transform_batch(
        self, batch: Dict[str, torch.Tensor], carryover: Any = None
    ) -> Tuple[torch.Tensor, Any]:
        pos = batch[mp.positions.name]  # (T, N, 3)
        box = batch[mp.box_length.name]

        if carryover is None:
            last_pos = pos[0]
            last_image = torch.zeros_like(last_pos)
        else:
            last_pos, last_image = carryover

        # jumps between consecutive frames (incl. the seam to the last batch)
        extended = torch.cat([last_pos[None], pos])
        jumps = torch.round(torch.diff(extended, dim=0) / box)
        image = -torch.cumsum(jumps, dim=0) + last_image[None]
        unwrapped = pos + image * box
        return unwrapped, (pos[-1], image[-1])

    def bootstrap_carry(self, experiment, sp_name: str, offset: int):
        """Seam-free resume: reconstruct (last wrapped pos, last image count)
        from the already-stored frame ``offset - 1``."""
        frames = slice(offset - 1, offset)
        paths = [
            join_path(sp_name, mp.positions.name),
            join_path(sp_name, mp.unwrapped_positions.name),
        ]
        loaded = experiment.store.load(paths, frames=frames)
        pos, unwrapped = (torch.from_numpy(loaded[p][0]) for p in paths)
        box = torch.tensor(experiment.box_array, dtype=pos.dtype)
        image = torch.round((unwrapped - pos) / box)
        device = get_device()
        return pos.to(device), image.to(device)


class UnwrapViaIndices(Transformation):
    """Unwrap using the dump's box-image counters: ``pos + images * box``."""

    input_properties = [mp.positions, mp.box_length, mp.box_images]
    output_property = mp.unwrapped_positions
    scale_function = {"linear": {"scale_factor": 2}}

    def transform_batch(self, batch, carryover=None):
        pos = batch[mp.positions.name]
        box = batch[mp.box_length.name]
        images = batch[mp.box_images.name]
        return pos + images * box, None


class CoordinateWrapper(Transformation):
    """Wrap unwrapped coordinates back into the box (optionally centered)."""

    input_properties = [mp.unwrapped_positions, mp.box_length]
    output_property = mp.positions
    scale_function = {"linear": {"scale_factor": 2}}

    def __init__(self, center_box: bool = True):
        self.center_box = center_box

    def transform_batch(self, batch, carryover=None):
        pos = batch[mp.unwrapped_positions.name]
        box = batch[mp.box_length.name]
        return wrap_coordinates(pos, box, self.center_box), None


class ScaleCoordinates(Transformation):
    """Scaled (fractional) -> cartesian coordinates: ``pos * box``."""

    input_properties = [mp.scaled_positions, mp.box_length]
    output_property = mp.positions
    scale_function = {"linear": {"scale_factor": 2}}

    def transform_batch(self, batch, carryover=None):
        return batch[mp.scaled_positions.name] * batch[mp.box_length.name], None


class VelocityFromPositions(Transformation):
    """Forward-difference velocities from unwrapped positions.

    The last frame's velocity duplicates the second-to-last (the forward
    difference has no successor), matching ``velocity_from_positions.py:45-59``.
    """

    input_properties = [mp.unwrapped_positions, mp.time_step, mp.sample_rate]
    output_property = mp.velocities_from_positions
    scale_function = {"linear": {"scale_factor": 2}}

    def transform_batch(self, batch, carryover=None):
        pos = batch[mp.unwrapped_positions.name]  # (T, N, 3)
        dt = batch[mp.time_step.name] * batch[mp.sample_rate.name]
        vel = (pos[1:] - pos[:-1]) / dt
        return torch.cat([vel, vel[-1:]]), None
