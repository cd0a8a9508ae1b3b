"""System-wide flux/current transformations (multi-species reductions).

Counterpart of ``lammps_analysis_tpu/transformations/flux_transforms.py`` in
torch ops on the ``(time, atoms, d)`` layout:

* ``IonicCurrent``                — ``ionic_current.py:40-60``
* ``TranslationalDipoleMoment``   — ``translational_dipole_moment.py:44-60``
* ``ThermalFlux``                 — ``thermal_flux.py:41-92``
* ``IntegratedHeatCurrent``       — ``integrated_heat_current.py:40-60``
* ``KinaciIntegratedHeatCurrent`` — ``kinaci_integrated_heat_current.py:41-90``
  (with per-species force-work integrals; see class note)
* ``MomentumFlux``                — ``momentum_flux.py:40-55``

Stress components use LAMMPS Voigt order ``[xx, yy, zz, xy, xz, yz]``.

Precision: the inputs arrive as stored (float32) and every product, atom
sum and time integral runs in float64; the runner stores the ``(T, d)``
result as float32. The JAX package's numpy host kernels
(``transform_batch_host``) route slabs to the host CPU when the TPU link is
slow; the port runs ``transform_batch`` on ``config.device`` only.
"""

from __future__ import annotations

import torch

from ..database.properties import mdsuite_properties as mp
from ..database.trajectory_store import join_path
from ..utils.config import get_device
from .base import Transformation

#: Voigt index of the symmetric stress tensor's (a, b) component
_VOIGT = ((0, 3, 4), (3, 1, 5), (4, 5, 2))


def _f64(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float64)


class _SpeciesSum(Transformation):
    """A flux that is the sum over species of one per-species term."""

    multi_species = True

    def term(self, props) -> torch.Tensor:
        """One species' ``(T, d)`` contribution, in float64."""
        raise NotImplementedError

    def transform_batch(self, batch, carryover=None):
        return sum(self.term(props) for props in batch.values()), None


class IonicCurrent(_SpeciesSum):
    """J(t) = sum_species q_s * sum_atoms v_i(t)."""

    input_properties = [mp.velocities, mp.charge]
    output_property = mp.ionic_current
    scale_function = {"linear": {"scale_factor": 2}}

    def term(self, props):
        # charge: (T, N, 1) stored, or a (1, 1, 1) metadata constant
        return torch.sum(_f64(props[mp.velocities.name]) * _f64(props[mp.charge.name]), dim=1)


class TranslationalDipoleMoment(_SpeciesSum):
    """M(t) = sum q_i r_i(t) over unwrapped positions."""

    input_properties = [mp.unwrapped_positions, mp.charge]
    output_property = mp.translational_dipole_moment
    scale_function = {"linear": {"scale_factor": 2}}

    def term(self, props):
        return torch.sum(
            _f64(props[mp.unwrapped_positions.name]) * _f64(props[mp.charge.name]), dim=1
        )


class ThermalFlux(_SpeciesSum):
    """J(t) = sum (KE+PE) v  -  sum sigma . v (per-atom stress contraction)."""

    input_properties = [
        mp.stress,
        mp.velocities,
        mp.kinetic_energy,
        mp.potential_energy,
    ]
    output_property = mp.thermal_flux
    scale_function = {"linear": {"scale_factor": 20}}

    def term(self, props):
        stress = _f64(props[mp.stress.name])  # (T, N, 6)
        vel = _f64(props[mp.velocities.name])  # (T, N, 3)
        energy = _f64(props[mp.kinetic_energy.name]) + _f64(props[mp.potential_energy.name])
        sigma = stress[..., torch.tensor(_VOIGT, device=stress.device)]  # (T, N, 3, 3)
        # phi_a = sum_b sigma_ab v_b, summed over atoms with the energy term
        phi = torch.einsum("tnab,tnb->ta", sigma, vel)
        return torch.sum(energy * vel, dim=1) - phi


class IntegratedHeatCurrent(_SpeciesSum):
    """R(t) = sum (KE+PE) r over unwrapped positions."""

    input_properties = [
        mp.unwrapped_positions,
        mp.kinetic_energy,
        mp.potential_energy,
    ]
    output_property = mp.integrated_heat_current
    scale_function = {"linear": {"scale_factor": 5}}

    def term(self, props):
        energy = _f64(props[mp.kinetic_energy.name]) + _f64(props[mp.potential_energy.name])
        return torch.sum(energy * _f64(props[mp.unwrapped_positions.name]), dim=1)


class KinaciIntegratedHeatCurrent(Transformation):
    """Kinaci integrated heat current with cross-batch force-work integrals.

    Per species: ``I_i(t) = integral dt' F_i . v_i`` accumulated with a
    cumulative sum and carried across batches; the current is
    ``sum_i r_i I_i + sum_i PE_i r_i``. NOTE: the reference accumulates the
    integrals of *all previously processed species* into each species' term
    (``kinaci_integrated_heat_current.py:61-86``, ``tf.add_n(integrals)``
    inside the species loop), which couples the result to species iteration
    order and — because ``add_n`` requires equal shapes — only even runs
    when every species has the same particle count. This implementation
    defaults to keeping each species' integral separate (the
    order-independent formulation); pass ``reference_accumulation=True``
    to reproduce the upstream coupled accumulation exactly (species in
    declaration order, total integral carried across batches).
    """

    input_properties = [
        mp.unwrapped_positions,
        mp.velocities,
        mp.forces,
        mp.potential_energy,
        mp.time_step,
        mp.sample_rate,
    ]
    output_property = mp.kinaci_heat_current
    scale_function = {"linear": {"scale_factor": 5}}
    multi_species = True
    requires_carryover = True

    #: carry key for the reference-mode total integral (all species)
    _TOTAL = "__reference_total__"

    def __init__(self, reference_accumulation: bool = False):
        self.reference_accumulation = bool(reference_accumulation)

    @staticmethod
    def _check_equal_counts(counts: dict, what: str = "") -> None:
        if len(set(counts.values())) > 1:
            raise ValueError(
                f"reference_accumulation{what} requires equal particle counts "
                f"per species (got {counts}): the reference's tf.add_n over "
                "per-species integrals only defines the coupled sum for "
                "equal shapes (kinaci_integrated_heat_current.py:82)."
            )

    def transform_batch(self, batch, carryover=None):
        if self.reference_accumulation:
            self._check_equal_counts(
                {sp: p[mp.unwrapped_positions.name].shape[1] for sp, p in batch.items()}
            )
        carry = carryover or {}
        out, new_carry = 0, {}
        # reference mode: each species' r.I term contracts with the RUNNING
        # SUM of all previously processed species' integrals (plus the
        # carried total), and the carry is that total
        running = carry.get(self._TOTAL)
        for sp, props in batch.items():
            pos = _f64(props[mp.unwrapped_positions.name])  # (T, N, 3)
            force_work = torch.sum(
                _f64(props[mp.forces.name]) * _f64(props[mp.velocities.name]), dim=-1
            )  # (T, N)
            dt = _f64(props[mp.time_step.name] * props[mp.sample_rate.name])
            integral = torch.cumsum(force_work, dim=0) * dt
            if self.reference_accumulation:
                running = integral if running is None else running + integral
                integral = running
            else:
                if sp in carry:
                    integral = integral + carry[sp]
                new_carry[sp] = integral[-1]
            pe = _f64(props[mp.potential_energy.name])  # (T, N, 1)
            out = out + torch.einsum("tn,tnd->td", integral, pos) + torch.sum(pe * pos, dim=1)
        if self.reference_accumulation:
            new_carry = {self._TOTAL: running[-1]}
        return out, new_carry

    def bootstrap_carry_multi(self, experiment, species, offset: int):
        """Exact append-resume: re-integrate each species' per-atom
        force-work integral over the already-processed frames ``[0,
        offset)`` in float64 on ``config.device``.

        The stored output is the species-summed current, so the per-atom
        integrals the carry needs are streamed from Velocities/Forces once
        (JAX package ``flux_transforms.py:307``)."""
        store = experiment.store
        device = get_device()
        dt = float(experiment.time_step) * float(experiment.sample_rate)
        carry = {}
        for sp in species:
            n = experiment.entity(sp).n_particles
            # ~256 MB of (vel + force) f32 rows per slab
            step = max(1, (1 << 28) // max(1, 2 * n * 3 * 4))
            total = torch.zeros(n, dtype=torch.float64, device=device)
            paths = [join_path(sp, mp.velocities.name), join_path(sp, mp.forces.name)]
            for a in range(0, offset, step):
                loaded = store.load(paths, frames=slice(a, min(offset, a + step)))
                vel, force = (_f64(torch.from_numpy(loaded[p]).to(device)) for p in paths)
                total += torch.sum(force * vel, dim=(0, 2))
            carry[sp] = total * dt
        if self.reference_accumulation:
            # upstream carries ONE total integral summed over species
            self._check_equal_counts({sp: len(v) for sp, v in carry.items()}, " resume")
            return {self._TOTAL: sum(carry.values())}
        return carry


class MomentumFlux(_SpeciesSum):
    """Off-diagonal stress sums for viscosity: (sum sxy, sum sxz, sum syz)."""

    input_properties = [mp.stress]
    output_property = mp.momentum_flux
    scale_function = {"linear": {"scale_factor": 5}}

    def term(self, props):
        return torch.sum(_f64(props[mp.stress.name][..., 3:6]), dim=1)
