"""Positions and velocities of ``nacl_gk_32k`` from a seed, on the card.

Each ion's velocity is an exact discrete Ornstein-Uhlenbeck process per
axis, in A/ps: stationary at the Maxwell-Boltzmann variance ``kT/m``, with
relaxation time ``tau = D m / kT``, so that ``v[t+1] = phi v[t] + sqrt(1 -
phi^2) sigma xi`` with ``phi = exp(-dt / tau)`` and ``v[0]`` drawn from the
stationary law. Its velocity autocorrelation is then ``(kT/m)
exp(-t/tau)``, whose Green-Kubo integral over three axes is ``D``: a
Langevin gas, not a melt. The positions start uniform in the box and move
by ``v dt`` a frame, wrapped into the box. One ``torch.Generator`` draws
the starts, then every frame's noise; the recursion runs in float64.
"""

from __future__ import annotations

import math

import torch

BOLTZMANN_J_K = 1.380649e-23
AMU_KG = 1.66053906660e-27


def ion_parameters(config: dict) -> dict:
    """Per species: ``sigma`` (A/ps), ``tau`` (ps) and ``phi`` of its
    velocities at the configuration's temperature, masses and D."""
    kt = BOLTZMANN_J_K * config["temperature"]
    dt = config["timestep"] * config["sample_rate"]  # sim time a frame
    velocity_unit = config["length_m"] / config["time_s"]  # m/s of one A/ps
    out = {}
    for name in config["species"]:
        mass = config["masses"][name] * AMU_KG
        tau = config["diffusion_m2_s"] * mass / kt / config["time_s"]
        out[name] = {"sigma": math.sqrt(kt / mass) / velocity_unit, "tau": tau,
                     "phi": math.exp(-dt / tau)}
    return out


def generate(config: dict, seed: int, device: str) -> dict:
    """``{"Positions", "Velocities"}``, each ``(n_frames, n_ions, 3)``
    float32 on ``device``: Na's ions, then Cl's."""
    params = ion_parameters(config)
    n_frames, box = config["n_frames"], float(config["box_length"])
    dt = config["timestep"] * config["sample_rate"]
    per_ion = {key: torch.cat([torch.full((n, 1), params[name][key], dtype=torch.float64,
                                          device=device)
                               for name, n in config["species"].items()])
               for key in ("sigma", "phi")}
    n_ions = sum(config["species"].values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    start = torch.rand((n_ions, 3), generator=gen, device=device, dtype=torch.float64) * box
    v = torch.randn((n_frames, n_ions, 3), generator=gen, device=device, dtype=torch.float64)
    v[0] *= per_ion["sigma"]
    kick = per_ion["sigma"] * torch.sqrt(1 - per_ion["phi"] ** 2)
    for t in range(1, n_frames):  # in place: the noise of frame t becomes v[t]
        v[t].mul_(kick).addcmul_(v[t - 1], per_ion["phi"])
    # x[0] is the start, x[t] = x[t-1] + v[t-1] dt
    pos = torch.cumsum(v, dim=0).sub_(v).mul_(dt).add_(start)
    wrapped = (pos - box * torch.floor(pos / box)).to(torch.float32)
    del pos
    # a coordinate just below 0 wraps to box - tiny, which rounds to box in float32
    wrapped = torch.where(wrapped >= box, wrapped - box, wrapped)
    return {"Positions": wrapped, "Velocities": v.to(torch.float32)}
