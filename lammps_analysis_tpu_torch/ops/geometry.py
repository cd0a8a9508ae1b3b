"""Minimum-image geometry shared by the pair kernels and their plain versions.

Counterpart of ``lammps_analysis_tpu/ops/geometry.py::minimum_image`` in the
form the port's kernels compute it: ``r - box * rint(r * (1/box))`` with the
float32 reciprocal ``1/box`` computed once on the host (``box_scalars``), as
the TPU kernels do (``pallas_rdf.py:161-163``, ``pallas_adf.py:372``). The
JAX package's XLA path divides by the box instead; the two can differ for a
displacement within about one float32 ulp of half a box. The dividing form
is ``minimum_image_divided``, for the spatial distribution function, whose
shell test then keeps the pairs the JAX package keeps. Also the counterparts
of its ``wrap_coordinates`` (the coordinate wrapper and molecule mapping) and
``cartesian_to_spherical``/``spherical_to_cartesian`` (the SDF).
"""

from __future__ import annotations

import numpy as np
import torch


def box_scalars(box, what: str = "this kernel"):
    """``(box (3,), 1/box (3,))`` as Python floats holding float32 values.

    The reciprocals are float32 divisions, so a CUDA kernel handed these
    floats and a torch version applying :func:`minimum_image` with them
    round every step alike.
    """
    if box is None:
        raise ValueError(
            f"{what} applies the minimum image and needs a periodic box; "
            "got box=None"
        )
    b = torch.as_tensor(box, dtype=torch.float32).cpu().numpy().reshape(-1)
    if b.shape != (3,):
        raise ValueError(f"box must hold 3 edge lengths, got shape {b.shape}")
    ib = np.float32(1.0) / b
    return tuple(map(float, b)), tuple(map(float, ib))


def squared_cutoff(cutoff: float) -> float:
    """The float32 threshold ``t`` with ``sqrt(s) < cutoff`` exactly when ``s <= t``.

    ``t`` is the largest float32 ``s`` whose correctly rounded square root is
    below ``float32(cutoff)``. Square root rounded to nearest is monotone, so
    for the same rounded ``s = dx*dx + dy*dy + dz*dz`` the kernels' test
    ``s <= t`` keeps exactly the pairs that the plain versions' ``sqrt(s) <
    cutoff`` keeps, and the kernels take the square root of kept pairs only.
    ``float32(cutoff) ** 2`` is not this threshold: for a cutoff of 19.9 it is
    396.00998, and ``t`` is 396.00992.
    """
    c = np.float32(cutoff)
    if not c > 0:
        raise ValueError(f"need a positive cutoff, got {cutoff}")
    t = np.float32(c * c)
    while not np.sqrt(t) < c:
        t = np.nextafter(t, np.float32(0.0))
    while np.sqrt(np.nextafter(t, np.float32(np.inf))) < c:
        t = np.nextafter(t, np.float32(np.inf))
    return float(t)


def minimum_image(r: torch.Tensor, edge: float, inv_edge: float) -> torch.Tensor:
    """One Cartesian component of displacements wrapped into the primary image.

    ``torch.round`` rounds half to even, as ``rintf`` does in the kernels.
    """
    return r - edge * torch.round(r * inv_edge)


def wrap_coordinates(
    pos: torch.Tensor, box: torch.Tensor, center: bool = False
) -> torch.Tensor:
    """Wrap positions into the primary box image.

    Counterpart of ``lammps_analysis_tpu/ops/geometry.py::wrap_coordinates``:
    ``pos - box * floor(pos / box)``, in the inputs' dtype. ``center=True``
    wraps into ``[-box/2, box/2)`` instead of ``[0, box)`` (reference:
    ``transformations/wrap_coordinates.py:51-80``), shifting before the
    floor-wrap and back after, so the result stays congruent to the input
    modulo the box.
    """
    if center:
        pos = pos + box * 0.5
    wrapped = pos - box * torch.floor(pos / box)
    if center:
        wrapped = wrapped - box * 0.5
    return wrapped


def minimum_image_divided(r: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """Displacements wrapped into the primary image by dividing by the box.

    ``r - box * round(r / box)`` over a trailing axis of 3 (the JAX package's
    ``minimum_image``), in ``r``'s dtype; ``torch.round`` rounds half to
    even, as ``jnp.round`` does.
    """
    return r - box * torch.round(r / box)


def cartesian_to_spherical(xyz: torch.Tensor) -> torch.Tensor:
    """``(..., 3)`` cartesian -> ``(r, theta, phi)`` (reference ``linalg.py:139-183``).

    ``theta = arccos(z / r)`` with ``theta = 0`` at ``r = 0``, ``phi =
    atan2(y, x)``; ``r`` is ``sqrt(x*x + y*y + z*z)`` summed in that order.
    """
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    positive = r > 0
    theta = torch.arccos(torch.where(positive, z / torch.where(positive, r, 1.0), 1.0))
    phi = torch.atan2(y, x)
    return torch.stack([r, theta, phi], dim=-1)


def spherical_to_cartesian(rtp: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`cartesian_to_spherical` (reference ``linalg.py:185-219``)."""
    r, theta, phi = rtp[..., 0], rtp[..., 1], rtp[..., 2]
    return torch.stack(
        [
            r * torch.sin(theta) * torch.cos(phi),
            r * torch.sin(theta) * torch.sin(phi),
            r * torch.cos(theta),
        ],
        dim=-1,
    )
