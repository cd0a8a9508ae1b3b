"""Post-processing calculators: derived observables from a prior RDF.

Copied from ``lammps_analysis_tpu/calculators/post_processing.py``. These
consume a cached RDF :class:`Computation` (auto-running the RDF with
default args when none is supplied — reference pattern,
``coordination_number_calculation.py:182-185``) and run on host
NumPy/SciPy; there is no device work to shard.

Ports (MDSuite's ``mdsuite/calculators/``):

* CoordinationNumbers — ``coordination_number_calculation.py:84-408``
* PotentialOfMeanForce — ``potential_of_mean_force.py:58-378``
* KirkwoodBuffIntegral — ``kirkwood_buff_integrals.py:52-206``
* StructureFactor — ``structure_factor.py:62-372`` (disabled upstream; this
  build uses the physically-standard Faber-Ziman weights / Cromer-Mann
  form factors — divergences documented inline)
* NernstEinsteinIonicConductivity — ``nernst_einstein_ionic_conductivity.py``
  (broken upstream — relies on a deprecated data export; re-implemented
  cleanly from the Nernst-Einstein relation)
"""

from __future__ import annotations

import logging
from typing import Any, Dict

import numpy as np
from scipy.integrate import cumulative_trapezoid
from scipy.signal import find_peaks

from ..data.form_factors import form_factor
from ..database.results_db import Computation
from ..utils.meta import golden_section_search, smooth_series
from ..utils.units import boltzmann_constant, elementary_charge
from .base import Calculator

log = logging.getLogger(__name__)


def split_pair(pair: str, names) -> tuple:
    """Split an RDF/distinct subject key ``"A_B"`` into two KNOWN names.

    Species/molecule names may themselves contain underscores
    (``mol_1_mol_1``), so a bare ``pair.split("_")`` mis-parses; try
    every split point and accept the one where both halves are known.
    (The reference carries this latent bug for molecule names,
    ``coordination_number_calculation.py:220-223``.)
    """
    for i, ch in enumerate(pair):
        if ch != "_":
            continue
        sp_a, sp_b = pair[:i], pair[i + 1:]
        if sp_a in names and sp_b in names:
            return sp_a, sp_b
    raise ValueError(
        f"Pair key {pair!r} does not split into two known entities "
        f"({sorted(names)})."
    )


class _RDFPostProcessor(Calculator):
    """Shared: resolve the input RDF computation and its parameters."""

    def _entity_names(self) -> set:
        """Known entity names (species + mapped molecules) for pair keys."""
        exp = self.experiment
        return (
            {n for n in exp.species if n != "Observables"}
            | set(exp.molecules)
        )

    def _resolve_rdf(self, rdf_data) -> Computation:
        if isinstance(rdf_data, Computation):
            return rdf_data
        return self.experiment.run.RadialDistributionFunction(plot=False)

    @staticmethod
    def _rdf_args(rdf: Computation) -> Dict[str, Any]:
        """Cache-key contribution of the source RDF: its FULL argument dict.

        Keying only bins/cutoff/n_configs let two RDFs differing in
        species, start/stop or atom_selection collide and serve a stale
        post-processed result (violating base.py's contract that every
        argument affecting the numerical result is in the key).
        NernstEinstein already embeds its sources' full args (:344-351).
        """
        return {"rdf_args": dict(rdf.computation_parameter)}


class CoordinationNumbers(_RDFPostProcessor):
    """Coordination numbers from shells of the integrated RDF.

    CN(r) = 4 pi rho int_0^r g(r') r'^2 dr'; shell boundaries from
    golden-section minima between savgol-filtered RDF peaks; CN of shell k
    is the mean of the integral at the two boundary estimates.
    """

    result_series_keys = ["r", "cn"]

    def prepare_args(
        self,
        rdf_data=None,
        savgol_order: int = 2,
        savgol_window_length: int = 17,
        number_of_shells: int = 1,
        **kwargs,
    ) -> Dict[str, Any]:
        self.rdf_data = self._resolve_rdf(rdf_data)
        return {
            "savgol_order": int(savgol_order),
            "savgol_window_length": int(savgol_window_length),
            "number_of_shells": int(number_of_shells),
            **self._rdf_args(self.rdf_data),
        }

    def _find_shells(self, radii, rdf):
        """Shell boundary indices (reference ``:227-296``)."""
        a = self.args
        filtered = smooth_series(
            rdf, a["savgol_window_length"], a["savgol_order"]
        )
        peaks = find_peaks(filtered, height=1.0)[0]
        if len(peaks) < a["number_of_shells"] + 1:
            raise ValueError(
                "Not enough RDF peaks for the requested number of shells; "
                "reduce number_of_shells or improve RDF statistics."
            )
        shells = {}
        for i in range(a["number_of_shells"]):
            lo, hi = golden_section_search(
                [radii, rdf], radii[peaks[i + 1]], radii[peaks[i]]
            )
            shells[i] = (
                int(np.argmin(np.abs(radii - lo))),
                int(np.argmin(np.abs(radii - hi))),
            )
        return shells

    def run_calculator(self) -> Dict[str, dict]:
        exp = self.experiment
        volume_nm3 = exp.volume * exp.units.volume / 1e-27  # nm^3 (:210-218)
        names = self._entity_names()
        results = {}
        for pair, vals in self.rdf_data.data_dict.items():
            radii = np.asarray(vals["x"], dtype=float)[1:]
            rdf = np.asarray(vals["y"], dtype=float)[1:]
            # reference convention: the FIRST species' density
            # (coordination_number_calculation.py:220-223); split against
            # the known names so molecule entities with underscores resolve
            sp0 = split_pair(pair, names)[0]
            density = exp.entity(sp0).n_particles / volume_nm3
            integral = 4 * np.pi * density * cumulative_trapezoid(
                radii[1:] ** 2 * rdf[1:], x=radii[1:]
            )
            data = {"r": radii[1:].tolist(), "cn": integral.tolist()}
            try:
                shells = self._find_shells(radii, rdf)
                for k, (i0, i1) in shells.items():
                    i0 = min(i0, len(integral) - 1)
                    i1 = min(i1, len(integral) - 1)
                    pair_vals = [integral[i0], integral[i1]]
                    data[f"CN_{k + 1}"] = float(np.mean(pair_vals))
                    data[f"CN_{k + 1}_error"] = float(
                        np.std(pair_vals) / np.sqrt(2)
                    )
            except ValueError as err:
                log.warning("CN shells not found for %s: %s", pair, err)
            results[pair] = data
        return results


class PotentialOfMeanForce(_RDFPostProcessor):
    """w(r) = -kT ln g(r) in eV, with per-shell minimum values."""

    result_series_keys = ["r", "pomf"]

    def prepare_args(
        self,
        rdf_data=None,
        savgol_order: int = 2,
        savgol_window_length: int = 17,
        number_of_shells: int = 1,
        **kwargs,
    ) -> Dict[str, Any]:
        self.rdf_data = self._resolve_rdf(rdf_data)
        return {
            "savgol_order": int(savgol_order),
            "savgol_window_length": int(savgol_window_length),
            "number_of_shells": int(number_of_shells),
            **self._rdf_args(self.rdf_data),
        }

    def run_calculator(self) -> Dict[str, dict]:
        exp = self.experiment
        a = self.args
        results = {}
        for pair, vals in self.rdf_data.data_dict.items():
            radii = np.asarray(vals["x"], dtype=float)[1:]
            rdf = np.asarray(vals["y"], dtype=float)[1:]
            with np.errstate(divide="ignore", invalid="ignore"):
                # -kT ln g, converted J -> eV x1e8 per reference (:192-201)
                pomf = (
                    -boltzmann_constant
                    * exp.temperature
                    * np.log(np.where(rdf > 0, rdf, np.nan))
                ) * 6.242e8
            data = {"r": radii.tolist(), "pomf": np.nan_to_num(pomf).tolist()}
            try:
                finite = np.nan_to_num(pomf, nan=np.nanmax(pomf[np.isfinite(pomf)]))
                filtered = smooth_series(
                    finite, a["savgol_window_length"], a["savgol_order"]
                )
                peaks = find_peaks(filtered)[0]
                if len(peaks) < a["number_of_shells"] + 1:
                    raise ValueError("not enough POMF peaks")
                for i in range(a["number_of_shells"]):
                    lo, hi = golden_section_search(
                        [radii, finite], radii[peaks[i + 1]], radii[peaks[i]]
                    )
                    i0 = int(np.argmin(np.abs(radii - lo)))
                    i1 = int(np.argmin(np.abs(radii - hi)))
                    pair_vals = [finite[i0], finite[i1]]
                    data[f"POMF_{i + 1}"] = float(np.mean(pair_vals))
                    data[f"POMF_{i + 1}_error"] = float(
                        np.std(pair_vals) / np.sqrt(2)
                    )
            except ValueError as err:
                log.warning("POMF minima not found for %s: %s", pair, err)
            results[pair] = data
        return results


class KirkwoodBuffIntegral(_RDFPostProcessor):
    """G_ab(r) = 4 pi int (g(r') - 1) r'^2 dr' on the savgol-filtered RDF."""

    result_series_keys = ["r", "kb_integral"]

    def prepare_args(
        self,
        rdf_data=None,
        savgol_order: int = 2,
        savgol_window_length: int = 17,
        **kwargs,
    ) -> Dict[str, Any]:
        self.rdf_data = self._resolve_rdf(rdf_data)
        return {
            "savgol_order": int(savgol_order),
            "savgol_window_length": int(savgol_window_length),
            **self._rdf_args(self.rdf_data),
        }

    def run_calculator(self) -> Dict[str, dict]:
        a = self.args
        results = {}
        for pair, vals in self.rdf_data.data_dict.items():
            radii = np.asarray(vals["x"], dtype=float)[1:]
            rdf = np.asarray(vals["y"], dtype=float)[1:]
            filtered = smooth_series(
                rdf, a["savgol_window_length"], a["savgol_order"]
            )
            integral = 4 * np.pi * cumulative_trapezoid(
                (filtered[1:] - 1) * radii[1:] ** 2, x=radii[1:]
            )
            results[pair] = {
                "r": radii[1:].tolist(),
                "kb_integral": integral.tolist(),
            }
        return results


class StructureFactor(_RDFPostProcessor):
    """Total and partial static structure factors S(q) from the RDF.

    Faber-Ziman formalism: partial
    ``S_ab(q) = 1 + 4 pi rho_0 int r^2 (g_ab - 1) sin(qr)/(qr) dr`` and
    total ``S(q) = sum_ab (2 - delta_ab) x_a x_b f_a f_b S_ab / <f>^2``
    with Cromer-Mann form factors. (The upstream implementation — disabled
    there — omitted the density factor and used a linear-in-q form-factor
    exponent; this build uses the standard expressions.)
    """

    result_series_keys = ["q", "S"]

    def prepare_args(
        self, rdf_data=None, resolution: int = 700,
        method: str = "Faber-Ziman", **kwargs
    ) -> Dict[str, Any]:
        # reference arg contract (structure_factor.py:142); Faber-Ziman is
        # the only formalism upstream supports too — reject others loudly
        # instead of silently ignoring the request
        if method != "Faber-Ziman":
            raise ValueError(
                f"{self.name}: unsupported method {method!r}; only "
                "'Faber-Ziman' is implemented (same as the reference)."
            )
        self.rdf_data = self._resolve_rdf(rdf_data)
        return {"resolution": int(resolution), **self._rdf_args(self.rdf_data)}

    @staticmethod
    def _split_pair(pair: str, names) -> tuple:
        """See :func:`split_pair` (kept as a method for API stability)."""
        try:
            return split_pair(pair, names)
        except ValueError:
            raise ValueError(
                f"StructureFactor: RDF pair key {pair!r} does not split "
                f"into two known entities ({sorted(names)}). Pass the "
                "matching rdf_data and make sure its species exist in the "
                "experiment."
            ) from None

    def run_calculator(self) -> Dict[str, dict]:
        exp = self.experiment
        a = self.args
        q = np.linspace(0.5, 12.0, a["resolution"])  # 1/Angstrom (:175)
        volume_ang3 = exp.volume * exp.units.volume / 1e-30
        # weight fractions over the source RDF's own subjects when known
        # (falling back to the experiment's species) so molecule-based or
        # restricted RDFs don't KeyError; entity() resolves both kinds
        rdf_species = (a.get("rdf_args") or {}).get("species")
        names = [
            n
            for n in (rdf_species if rdf_species else exp.species)
            if n != "Observables"
        ]
        infos = {n: exp.entity(n) for n in names}
        n_total = sum(sp.n_particles for sp in infos.values())
        rho_0 = n_total / volume_ang3

        x = {name: sp.n_particles / n_total for name, sp in infos.items()}
        try:
            f = {name: form_factor(name, q) for name in infos}
        except KeyError as err:
            raise ValueError(
                "StructureFactor needs Cromer-Mann form factors for every "
                "RDF subject — molecule COM trajectories have no atomic "
                f"form factor. ({err})"
            ) from err
        f_mean = sum(x[name] * f[name] for name in infos)

        results = {}
        total = np.zeros_like(q)
        for pair, vals in self.rdf_data.data_dict.items():
            radii = np.asarray(vals["x"], dtype=float)[1:] * 10  # nm -> Ang
            rdf = np.asarray(vals["y"], dtype=float)[1:]
            qr = np.outer(q, radii)
            kernel = radii**2 * np.sin(qr) / qr
            s_partial = 1 + 4 * np.pi * rho_0 * np.trapezoid(
                kernel * (rdf - 1), x=radii, axis=1
            )
            results[pair] = {"q": q.tolist(), "S": s_partial.tolist()}
            sp_a, sp_b = self._split_pair(pair, infos)
            factor = 1.0 if sp_a == sp_b else 2.0
            weight = (
                factor * x[sp_a] * x[sp_b] * f[sp_a] * f[sp_b] / f_mean**2
            )
            total += weight * (s_partial - 1)
        results["System"] = {"q": q.tolist(), "S": (1 + total).tolist()}
        return results


class NernstEinsteinIonicConductivity(Calculator):
    """sigma_NE = (N e^2 / V k_B T) * sum_i x_i q_i^2 D_i.

    Re-implementation of ``nernst_einstein_ionic_conductivity.py:36-402``
    (the upstream version depends on a deprecated export API and cannot
    run); takes a diffusion-coefficients Computation (Einstein or
    Green-Kubo), species charges from the experiment, and evaluates the
    Nernst-Einstein relation in SI units.
    """

    result_keys = ["nernst_einstein_ionic_conductivity", "uncertainty"]
    result_series_keys = []

    def prepare_args(
        self, diffusion_data=None, distinct_diffusion_data=None,
        corrected: bool = False, species: list = None,
        data_range: int = None, **kwargs
    ) -> Dict[str, Any]:
        # reference arg contract (nernst_einstein_...py:69-104):
        # ``data_range`` parameterises the underlying diffusion run,
        # ``species`` restricts which species' D_i enter the sum
        auto_kwargs = {"plot": False}
        if data_range is not None:
            auto_kwargs["data_range"] = int(data_range)
        if isinstance(diffusion_data, Computation):
            self.diffusion_data = diffusion_data
        else:
            self.diffusion_data = self.experiment.run.EinsteinDiffusionCoefficients(
                **auto_kwargs
            )
        self.distinct_diffusion_data = (
            distinct_diffusion_data
            if isinstance(distinct_diffusion_data, Computation)
            else None
        )
        # reference arg contract (nernst_einstein_...py:71): corrected=True
        # adds the distinct (cross) terms; auto-run them if not supplied
        if corrected and self.distinct_diffusion_data is None:
            self.distinct_diffusion_data = (
                self.experiment.run.EinsteinDistinctDiffusionCoefficients(**auto_kwargs)
            )
        args = {
            "diffusion_source": self.diffusion_data.name,
            "diffusion_args": self.diffusion_data.args,
        }
        if species is not None:
            args["species"] = list(species)
        if self.distinct_diffusion_data is not None:
            args["distinct_source"] = self.distinct_diffusion_data.name
            args["distinct_args"] = self.distinct_diffusion_data.args
        return args

    def run_calculator(self) -> Dict[str, dict]:
        exp = self.experiment
        volume_si = exp.volume * exp.units.volume
        n_total = sum(
            sp.n_particles
            for name, sp in exp.species.items()
            if name != "Observables"
        )
        entity_names = {
            n for n in exp.species if n != "Observables"
        } | set(exp.molecules)
        selected = self.args.get("species")
        sigma = 0.0
        var = 0.0
        for sp_name, vals in self.diffusion_data.data_dict.items():
            if sp_name not in entity_names:
                continue
            if selected is not None and sp_name not in selected:
                continue
            sp = exp.entity(sp_name)
            d = np.atleast_1d(vals["diffusion_coefficient"])[0]
            d_err = np.atleast_1d(vals.get("uncertainty", 0.0))[0]
            x_i = sp.n_particles / n_total
            q2 = (sp.charge * elementary_charge) ** 2
            prefactor = n_total * q2 / (
                volume_si * boltzmann_constant * exp.temperature
            )
            sigma += prefactor * x_i * d
            var += (prefactor * x_i * d_err) ** 2
        log.info("%s sigma_NE = %.6e S/m", self.name, sigma)
        result = {
            "nernst_einstein_ionic_conductivity": float(sigma),
            "uncertainty": float(np.sqrt(var)),
        }

        # corrected NE: add distinct (cross-species) diffusion terms
        # (reference ``nernst_einstein_ionic_conductivity.py:208+``)
        if getattr(self, "distinct_diffusion_data", None) is not None:
            sigma_d = 0.0
            base = n_total * elementary_charge**2 / (
                volume_si * boltzmann_constant * exp.temperature
            )
            for pair, vals in self.distinct_diffusion_data.data_dict.items():
                try:
                    names = split_pair(pair, entity_names)
                except ValueError:
                    continue
                if selected is not None and not all(
                    n in selected for n in names
                ):
                    continue
                sp_a, sp_b = (exp.entity(n) for n in names)
                x_a = sp_a.n_particles / n_total
                x_b = sp_b.n_particles / n_total
                d_ab = np.atleast_1d(vals["diffusion_coefficient"])[0]
                factor = 1.0 if names[0] == names[1] else 2.0
                sigma_d += (
                    base * factor * x_a * x_b
                    * sp_a.charge * sp_b.charge * d_ab
                )
            result["corrected_nernst_einstein_ionic_conductivity"] = float(
                sigma + sigma_d
            )
        return {"System": result}

    def plot_results(self, computation):  # scalar result - nothing to plot
        pass
