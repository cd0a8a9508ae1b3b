#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lammps_analysis_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is not 0):

0. environment: torch and CUDA versions, the card's name, compute capability,
   ``torch.cuda.device_count()`` and power limit, and which optional packages
   import (for the record: the port's main path needs none of them);
1. build: nvcc compiles ``lammps_analysis_tpu_torch/csrc/*.cu`` for sm_90a,
   one nvcc per source, side by side; g++ builds the table parser and the
   native CPU RDF, ADF and SDF kernels (``native/*_kernel.cpp``, the bars,
   ``native_rdf``, ``native_adf``, ``native_sdf``);
2. kernel vs plain, each kernel and its plain torch version on the same
   seeded inputs on the card, with the kernel's device time (``torch.profiler``,
   after a warm-up call), the plain version's time (CUDA events around
   back-to-back calls) and the kernel's bound:
   * ``[2 kernel]`` the RDF pair histogram in each of its histogram modes,
     equal bin for bin, each with its layout's blocks and warps resident on
     an SM, the main path (64 x 10240, 2 species x 500 bins) beside the LJ
     shape (``LJ``: 32 x 32000, 1 species x 5709 bins); the native CPU RDF kernel (one thread) on the
     main-path launch's inputs, one call's wall, within its bin-edge
     differences of K1; its i-row range (the 2-D RDF's mode) on one rank's
     launch, 32 frames x 10240 atoms: stripes of 2 and 4 each equal to the
     plain version and adding up to the full launch bit for bit, each
     stripe's time and bound (the triangle's imbalance);
   * ``[2 extract]`` both routes of the ADF neighbor extract (the sweep and
     the cell lists), all six outputs equal (a saturated binned case on the
     rows that fit K and on ``counts``; a dense case whose counts cross the
     sweep's 32-slot lines), with the routes' times side by side;
     the center stripe (the 2-D ADF's mode) of both routes on 8 frames x
     10240 atoms: stripes of 1, 2 and 4 equal to the plain version and to the
     rows of the full launch, the first of two timed with its bound; the
     ``idx`` output on both routes (16 x 10240) and open boundaries on the
     sweep (a 10240-atom droplet, no box), every output equal to the plain
     version bit for bit; the sorted route, z and brick sorts, at the
     wide-list shape (``WIDE``: 2 x 32768 atoms, 64 A box, cutoff 10 A, K =
     1024): equal to the plain sorted extract bit for bit, no overflow under
     the sort's bound, every atom's neighbor set equal to the sweep's; each
     mode's device time beside the sweep's and one bound, the widest window;
     beside each sweep mode's bound its own test floor (the tests the sweep
     makes, every center against every atom of its range, at 22 float32
     operations over the peak: ``floor_ms`` in its kernel records);
   * ``[2 angles]`` the ADF angle histogram on those lists, K > 1024 too,
     a frame of mixed widths (a dense cluster among first shells), 64 frames
     in one launch and seeded lists with 0, 1, 2, 32, 33, K and more entries
     and padding ids: totals within rtol 1e-5, at most max(2, size // 64)
     bins outside rtol 1e-4 (float64 atomics add in another order, acosf may
     differ by an ulp); each line names the kernel's split
     (``pairs_histogram_route``): where the float64 histogram lives, the
     chunks of ``chunk_pairs`` pairs a center is cut into, the blocks a frame;
   * ``[2 acf]`` the windowed ACF's pack and power-sum kernels
     (``csrc/acf_power.cu``) at GK self-diffusion's full FFT batch (32
     windows x 48000 sequences padded to 1024): the pack equal to the plain
     version bit for bit, with and without its zero tail, and kept by
     cuFFT's R2C; the power sum within 1e-12 of the plain version on every
     bin and bit for bit from run to run; each kernel's device time beside
     its bound, the plain version's time and the torch chain's it replaced;
     the peak device memory after each step of one batch; one GK slab
     through the kernels and through the old torch loop, in turns;
3. main paths, each through ``Project`` -> in-memory ingest -> ``exp.run``,
   checked to go through its kernels and never the plain versions, to give
   the ideal gas's answer and to be a cache hit when run again, then run on
   a small input on the card and on the CPU, which must agree:
   * ``[3 main]`` the RDF, 64 frames x 10240 atoms, 500 bins;
   * ``[3 adf]`` the ADF, 16 frames x 10240 atoms, cutoff 3.6 A, 500 bins,
     through the binned extract (16 launches, no sweep, no plain call); the
     native CPU ADF kernel on 16 such frames beside ``adf_histogram`` (K2
     then K3), within the angle-histogram tolerance;
   * ``[3 adf-wide]`` the ADF calculator at ``WIDE`` (2 frames): K = 512
     binned and saturated, then K = 1024 on the brick-sorted route, held to
     the same call on the sweep (the ADF allowance), forced walls of both,
     the device's idle share; ``adf_histogram`` one-shot at 2 x 10240 atoms,
     cutoff 10 A (the z sort) against the sweep's; ``adf_histogram`` and
     ``neighbor_indices`` with ``box=None`` on the droplet and
     ``neighbor_indices`` on ``[3 adf]`` frames (binned), against the plain
     versions;
   * ``[3 orchestration]`` ``plot=True`` on the ``[3 main]`` RDF writes its
     HTML (the panels hold the result), one forced RDF call under
     ``utils.profiling.device_trace`` with an ``annotate`` span leaves a
     Chrome trace naming K1's kernel and the span; ``exp.time_series.Energies``
     on the ``[3 flux]`` experiment against float64 sums of the stored
     arrays; the ``Report``;
   * ``[3 transport]`` the transport path from a file: a LAMMPS dump of the
     same system (500 frames, shuffled ids, wrapped positions, a random walk
     of 0.3 A a frame per axis whose step is exactly the written velocity
     times the frame interval) -> ``add_experiment(simulation_data=path)``
     (metadata and parse rate) -> the RDF on K1 from the file ->
     ``EinsteinDiffusionCoefficients`` (auto-unwrap on the card; unwrapped
     positions within 1e-3 A of the walk, D within 3 % of sigma^2 / (2 dt))
     and ``GreenKuboDiffusionCoefficients`` (D within 5 % of the same and of
     Einstein's), Na's MSD and ACF series equal to float64 direct sums of
     the stored arrays on the CPU (``tests/torch_dumps.py``, the tests'
     tolerance), slabs and transformation on the card, FFT and reduction
     kernels in the trace, cache hits, and card == CPU on a small dump
     (parsed arrays identical, series within the transport tolerance); with
     ``config.fuse_streaming`` and the unwrap dropped, a forced Einstein call
     unwraps each slab on the card, stores nothing and equals the
     materialised call float for float;
   * ``[3 distinct]`` the distinct diffusion pair on the same experiment
     (range 200): Einstein and Green-Kubo for Na_Na, Na_Cl and Cl_Cl on the
     card, every series held to float64 bilinear direct sums of the stored
     arrays (``tests/torch_dumps.py``), the Einstein D(Na_Na), D(Cl_Cl)
     within 3 % of -(1 - 1/N) sigma^2 / (2 dt) (MDSuite's definition: the
     self term dominates) and |D(Na_Cl)| under 1 % of sigma^2 / (2 dt), the
     GK |D(Na_Cl)| under 2 % of |D(Na_Na)|, then Nernst-Einstein with
     ``corrected=True``, which runs the distinct pair itself;
   * ``[3 sdf]`` the spatial distribution function with its defaults on the
     ``[3 main]`` ideal gas, Na-Cl and Na-Na: tiles on the card, counts held
     to the native CPU kernel (totals within 0.01 %, summed bin differences
     within max(4, 1e-4 x the total)), the total within 1 % of the ideal
     gas's pairs in the shell, the theta marginal within 5 sigma of its
     cos-difference shares, the peak device memory a pair of a tile within
     ``PEAK_BYTES_PER_PAIR``;
   * ``[3 post]`` the RDF post-processing (coordination numbers, potential
     of mean force, Kirkwood-Buff integrals, structure factor) over the
     ``[3 main]`` RDF that K1 computed (the ideal gas's coordination number
     is rho 4/3 pi r^3) and over K1's RDF of a rock-salt lattice (first
     shells of 6 and 12), equal on the card and the CPU;
   * ``[3 flux]`` the conductivity path at full width: a LAMMPS dump of the
     transport system with forces, per-atom energies and stresses (250
     frames) -> charges from the experiment -> the six system calculators
     that read a flux transformation, which the dependency check runs on
     the card (the unwrap too); every ``Observables`` series against a
     float64 numpy evaluation of its formula on the stored arrays, every
     value against the float64 estimator on those series, Nernst-Einstein
     over the ``[3 transport]`` Einstein and GK results against
     e^2/(V kB T) sum q^2 N sigma^2/(2 dt), cache hits, card == CPU on a
     small dump;
   * ``[3 flux-file]`` a 10^6-row LAMMPS flux log of white-noise heat flux
     and off-diagonal pressures -> ``LAMMPSFluxFile`` -> the GK thermal
     conductivity and the flux-file viscosity, against the float64
     estimator and the white-noise value;
   * ``[3 water]`` MDSuite's water study from GROMACS files: 3375 rigid
     waters (10125 atoms, OW HW1 HW2 rows, wrapped per atom so that some
     hundreds straddle a face at frame 0), 500 frames, written as a TRR and
     a DCD (and the first 50 frames as a ``.gro`` and an extxyz,
     ``tests/torch_water.py``) -> each reader through ``add_experiment``
     (MB/s, arrays against the generator) -> ``MolecularMap`` with
     ``[H]O[H]`` at 1.7 A on the TRR experiment (unwrap, adjacency and COM
     on the card; every COM within 1e-3 A of the generator's, the wrapped
     ones in [0, L); a second call is a no-op) -> the molecular Einstein
     (D within 3 % of sigma^2 / (2 dt)), the molecular RDF (K1, no plain
     call) and the atomistic ADF at 1.2 A (binned K2 and K3, the O_H_H peak
     within 1 deg of 109.47), cache hits, card == CPU on 64 waters;
   * ``[3 api]`` the JAX package's last public names: each new op on CUDA
     tensors equal to the same call on the CPU, ``PrefetchingLoader``,
     ``get_machine_properties``, ``change_memory_fraction`` (``api_path``);
   * ``[3 examples]`` the five examples of ``lammps_analysis_tpu_torch/examples``
     through their ``main()`` on the card, with their figures and launches
     (K1, binned K2 and K3, no plain call), the multi-device one on 4 gloo
     ranks sharing the card; molten NaCl once more at 2 x 5120 ions with
     its forced RDF and Einstein walls (``examples_path``);
4. ``[4 profile]``: seven forced (not cached) calls of each main path on the
   warm process (median wall), then one under ``torch.profiler``: device
   time per kernel, the largest device consumers, and the share of the call
   the device is busy; for the transport path also a forced Einstein call
   that re-runs the unwrap, the ingest wall and M window-frame-atoms/s; for
   the conductivity path each system calculator and each flux
   transformation (re-run), and the flux log's parse rate; for the water
   path ``MolecularMap`` (re-run), the molecular Einstein and RDF and the
   ADF, ``MolecularMap``'s layer spans and the readers' parse rates; the
   fused Einstein, both distinct classes and the SDF (Na-Cl, Na-Na).

5. ``[5 mesh]``: the multi-device layer (``parallel/``) on the RDF (64 x
   10240), ADF (16 x 10240), Einstein and GK (the 500-frame dump) through
   ``exp.run``, each world held to the process alone on the same inputs
   (counts exactly, the ADF within its allowance, transport within rtol
   1e-5), with every rank's kernel launches (no plain call), cache hits, one
   DB row per computation (rank 0 writes), the forced calls' walls and
   their collectives: (a) a world of 1 on NCCL; (b) four ranks
   sharing the card over gloo, then on a (2, 2) mesh the RDF calculator
   through K1's i-rows and the sharded ADF through K2's center stripes, on
   the binned route and once on the sweep; (c) one rank a card over NCCL
   when the machine has two or more cards (else the line says why not).

``--k1`` runs only ``[1 build]`` and K1 at the main path's and the LJ shape,
each equal to the plain version, its device time in 3 rounds, for an A/B of
two checkouts' K1 on one card.
``--walls`` runs only the forced-call medians (the transport path's too)
and the angle kernel's one-frame launch, for an A/B of two checkouts on one
card. ``--acf-batches`` times the windowed ACF over a 10^6-row system
series with 32-window FFT batches and with the default ones, in turns.
``--acf`` runs only ``[1 build]`` and ``[2 acf]``.
``--extract`` runs only ``[1 build]``, the neighbor extract's cases of ``[2
extract]`` and ``[3 adf-wide]``, for an A/B of two checkouts' sweep kernels
on one card. ``--chunks`` times
the angle kernel at several chunk sizes (``adf_kernel.PAIRS_CHUNK``) on the
one-frame launch, the mixed frame, K = 1076 and 16 main-path frames.

The second-to-last line is a JSON summary of the kernels (times, launches on
the main paths, the water path's and the examples' included, bounds; every record must have
launched on a main path), the last line the
device record ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing either.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import importlib.util
import inspect
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# the transport dump's and the water box's generators and writers and the
# transport tolerance, shared with the tests
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"))
import torch_dumps  # noqa: E402
import torch_water  # noqa: E402

CSRC = "lammps_analysis_tpu_torch/csrc/"
# the JAX package's native CPU kernels, built and bound here as bars for the card
NATIVE = pathlib.Path(__file__).resolve().parent / "native"
NATIVE_ADF_BIN_RANGE = (0.0, 3.15)  # radians, as ops/adf.py
REPLACES = {
    "rdf_histogram": "lammps_analysis_tpu/ops/pallas_rdf.py:85",
    "adf_neighbor_cells": "lammps_analysis_tpu/ops/pallas_adf.py:221",
    "adf_neighbor_extract": "lammps_analysis_tpu/ops/pallas_adf.py:221",
    "adf_pairs_histogram": "lammps_analysis_tpu/ops/pallas_adf.py:1482",
    # no Pallas kernel: XLA ops (jnp.fft) in the JAX package
    "acf_pack": "none: lammps_analysis_tpu/ops/correlation.py::windowed_acf_sum",
    "acf_power_sum": "none: lammps_analysis_tpu/ops/correlation.py::windowed_acf_sum",
}
# each kernel record's device kernels, by a part of their symbol names
DEVICE_KERNELS = {
    "rdf_histogram": ("rdf_histogram_kernel",),
    "adf_neighbor_cells": ("bin_atoms", "scan_counts", "scatter_atoms", "cells_extract"),
    "adf_neighbor_extract": ("neighbor_extract_kernel",),
    "adf_pairs_histogram": ("adf_pairs_kernel",),
    "acf_pack": ("acf_pack_kernel",),
    "acf_power_sum": ("acf_power_sum_kernel", "acf_power_combine_kernel"),
}

RECORD_OF_ROUTE = {"binned": "adf_neighbor_cells", "sweep": "adf_neighbor_extract"}

# published peaks of one H100 SXM (dense, float32 outside the tensor cores)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# the bench workload of the JAX package: Na + Cl, box 40 A, cutoff 19.9 A
BENCH = dict(counts=[5120, 5120], box=(40.0, 40.0, 40.0), cutoff=19.9, n_bins=500)
# LAMMPS' bench/in.lj as the benchmark's lj_melt_32k holds it (argon, 32000
# atoms, 114.38 A box) under the RDF's defaults (cutoff box/2 - 0.1, 0.01 A
# bins): one species x 5709 bins, 125 blocks a frame
LJ = dict(counts=[32000], box=(114.38, 114.38, 114.38), cutoff=57.09, n_bins=5709)
# its ADF first-shell workload (bench.py:192-229): the same system, cutoff 3.6 A
ADF = dict(counts=[5120, 5120], box=(40.0, 40.0, 40.0), cutoff=3.6, n_bins=500)
ADF_RANGE = 3.15  # radians, ops/adf.py::ADF_BIN_RANGE
# wide neighbor lists: the same density (0.125 A^-3 here, 0.16 in the ADF
# box) at a 10 A cutoff, ~520 neighbors a center, K = 1024: too wide for the
# binned route, so the sorted route; 32768 atoms sort by (z-slab, y), 10240 by z
WIDE = dict(counts=[16384, 16384], box=(64.0, 64.0, 64.0), cutoff=10.0, n_bins=500, k_n=1024)
WIDE_Z = dict(counts=[5120, 5120], box=(40.0, 40.0, 40.0), cutoff=10.0, n_bins=500, k_n=1024)
# open boundaries: a droplet of 10240 atoms (radius 26.9 A, 0.125 A^-3), first shell
DROPLET = dict(counts=[5120, 5120], radius=26.9, cutoff=3.6, n_bins=500, k_n=128)
# the transport path's dump: the same system, 500 frames written every 10
# steps of 0.002 ps (metal units), a random walk of 0.3 A a frame per axis
TRANSPORT = dict(counts=[5120, 5120], box=40.0, n_frames=500, timestep=0.002,
                 every=10, sigma=0.3, data_range=200)
# the conductivity path's dump: the transport system at full width, cut to
# 250 frames, with seeded forces, per-atom energies and stresses, at 1200 K
FLUX = dict(TRANSPORT, n_frames=250, data_range=100, temperature=1200.0)
# a 10^6-step LAMMPS flux log (metal units, every 10 steps of 0.001 ps):
# white-noise heat flux (sd 2 eV A/ps) and off-diagonal pressures (sd 500 bar)
FLUX_FILE = dict(n_rows=1_000_000, sigma_flux=2.0, sigma_pressure=500.0, timestep=0.001,
                 every=10, box=40.0, temperature=1200.0, data_range=200)
# system calculator -> (the Observables series it reads, its ACF scale: 1, the
# data_range, or None for an Einstein-Helfand MSD)
SYSTEM = {
    "GreenKuboIonicConductivity": ("Ionic_Current", 1),
    "EinsteinHelfandIonicConductivity": ("Translational_Dipole_Moment", None),
    "GreenKuboThermalConductivity": ("Thermal_Flux", "range"),
    "EinsteinHelfandThermalConductivity": ("Integrated_Heat_Current", None),
    "EinsteinHelfandThermalKinaci": ("Kinaci_Heat_Current", None),
    "GreenKuboViscosity": ("Momentum_Flux", "range"),
    "GreenKuboViscosityFlux": ("Stress_Visc", "range"),
}
FLUX_TRANSFORMATIONS = {
    "IonicCurrent": "Ionic_Current", "TranslationalDipoleMoment": "Translational_Dipole_Moment",
    "ThermalFlux": "Thermal_Flux", "IntegratedHeatCurrent": "Integrated_Heat_Current",
    "KinaciIntegratedHeatCurrent": "Kinaci_Heat_Current", "MomentumFlux": "Momentum_Flux",
}
POST = ("CoordinationNumbers", "PotentialOfMeanForce", "KirkwoodBuffIntegral", "StructureFactor")
# MDSuite's water study (GROMACS water, ``CI/functional_tests/test_water_study.py``):
# 15^3 rigid SPC/E-geometry waters, 10125 atoms in a 46.6 A box (0.997 g/cm^3),
# COM walk of 0.1 A a frame per axis, 500 frames every 10 steps of 0.002 ps;
# the .gro and extxyz files hold the first 50
WATER = dict(n_side=15, box=46.6, n_frames=500, sigma=0.1, timestep=0.002, every=10,
             text_frames=50, data_range=200)


def phase(name: str, message: str) -> None:
    print(f"[{name}] {message}", flush=True)


def card_power_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit(
            "chip_smoke: torch finds no CUDA device; this script runs the port "
            "on an NVIDIA GPU"
        )
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    phase(
        "0 env",
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {name}, compute capability {cap}, "
        f"torch.cuda.device_count() {torch.cuda.device_count()}",
    )
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is {cap}")
    optional = {
        mod: importlib.util.find_spec(mod) is not None
        for mod in ("h5py", "pandas", "psutil", "matplotlib", "networkx", "chemfiles")
    }
    phase("0 env", f"optional packages present (not needed): {optional}")
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("no g++ on PATH: the dump reader's native parser is built with it")
    version = subprocess.run([gxx, "--version"], capture_output=True, text=True, timeout=60)
    phase("0 env", f"g++ for the table parser: {gxx}, {version.stdout.splitlines()[0]}")
    smi = card_power_line()
    print(smi, flush=True)
    return smi


def build() -> None:
    from lammps_analysis_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    seconds = time.perf_counter() - t0
    log = path.with_name(path.name + ".log")
    usage = [
        line.strip()
        for line in (log.read_text().splitlines() if log.exists() else [])
        if "registers" in line or "Compiling entry" in line
    ]
    phase("1 build", f"{path.name} in {seconds:.1f} s; ptxas: {' | '.join(usage)}")
    from lammps_analysis_tpu_torch.file_io import native_parser

    t0 = time.perf_counter()
    parser = native_parser.build()
    phase("1 build", f"table parser {parser.name} in {time.perf_counter() - t0:.1f} s (g++)")
    for name in ("rdf_kernel", "adf_kernel", "sdf_kernel"):
        t0 = time.perf_counter()
        bar = build_native(name)
        phase("1 build", f"native CPU bar {bar.name} in {time.perf_counter() - t0:.1f} s (g++)")


_F32 = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)


def build_native(name: str) -> pathlib.Path:
    """The library of ``native/<name>.cpp``, built unless it exists."""
    from lammps_analysis_tpu_torch.file_io import native_parser

    flags = native_parser.GXX_FLAGS + ("-fno-math-errno",)
    return native_parser.build(NATIVE / f"{name}.cpp", flags)


def _native_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_native(name)))


def _native_box(box):
    """``(array kept alive, pointer)`` of a float32 box, or a null pointer."""
    if box is None:
        return None, None
    arr = np.ascontiguousarray(box, np.float32)
    return arr, arr.ctypes.data_as(_F32)


def native_rdf():
    """``fn(pos (F, N, 3), species_id (N,), box, cutoff, n_bins, n_species)
    -> (n_pairs, n_bins) int64 counts``: the species blocks concatenated in
    order (padding ids -1 at the tail), pair ``(a, b)`` in the row order of
    the port's histograms."""
    lib = _native_library("rdf_kernel")
    lib.rdf_hist_f32.restype = ctypes.c_int64
    lib.rdf_hist_f32.argtypes = [
        _F32, ctypes.c_int64, ctypes.c_int64, _I32, _I32, ctypes.c_int32, _I32, _F32,
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint64),
    ]

    def run(pos, species_id, box, cutoff, n_bins, n_species):
        pos = np.ascontiguousarray(pos, np.float32)
        sid = np.asarray(species_id, np.int32)
        seg_start = np.array([np.flatnonzero(sid == s)[0] for s in range(n_species)], np.int32)
        seg_count = np.array([(sid == s).sum() for s in range(n_species)], np.int32)
        n_pairs = n_species * (n_species + 1) // 2
        table = np.zeros((n_species, n_species), np.int32)
        for k, (a, b) in enumerate((a, b) for a in range(n_species) for b in range(a, n_species)):
            table[a, b] = table[b, a] = k
        out = np.zeros((n_pairs, n_bins), np.uint64)
        _keep, box_ptr = _native_box(box)
        rc = lib.rdf_hist_f32(
            pos.ctypes.data_as(_F32), pos.shape[0], pos.shape[1],
            seg_start.ctypes.data_as(_I32), seg_count.ctypes.data_as(_I32), n_species,
            table.ctypes.data_as(_I32), box_ptr, float(cutoff), int(n_bins), n_pairs,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        )
        if rc != 0:
            raise RuntimeError(f"native RDF kernel returned {rc}")
        return out.astype(np.int64)

    return run


def native_adf():
    """``fn(pos (F, N, 3), species_id (N,), box or None, cutoff, n_bins,
    n_species, norm_power=4) -> (n_triples, n_bins) float64``: the weighted
    angle histogram of every frame, summed (neighbor search and angles in one
    call), triples in ``build_triple_table``'s order."""
    lib = _native_library("adf_kernel")
    lib.adf_hist_f32.restype = ctypes.c_int64
    lib.adf_hist_f32.argtypes = [
        _F32, ctypes.c_int64, ctypes.c_int64, _I32, ctypes.c_int32, _I32, _F32,
        ctypes.c_float, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_float, ctypes.c_float, ctypes.POINTER(ctypes.c_double),
    ]

    def run(pos, species_id, box, cutoff, n_bins, n_species, norm_power=4):
        pos = np.ascontiguousarray(pos, np.float32)
        sid = np.ascontiguousarray(species_id, np.int32)
        table = np.full((n_species,) * 3, -1, np.int32)
        k = 0
        for a in range(n_species):
            for b in range(a, n_species):
                for c in range(b, n_species):
                    table[a, b, c] = k
                    k += 1
        out = np.zeros((k, n_bins), np.float64)
        _keep, box_ptr = _native_box(box)
        rc = lib.adf_hist_f32(
            pos.ctypes.data_as(_F32), pos.shape[0], pos.shape[1], sid.ctypes.data_as(_I32),
            n_species, table.ctypes.data_as(_I32), box_ptr, float(cutoff), int(n_bins), k,
            int(norm_power), *NATIVE_ADF_BIN_RANGE, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if rc != 0:
            raise RuntimeError(f"native ADF kernel returned {rc}")
        return out

    return run


def native_sdf():
    """``fn(pos_a, pos_b, box, r_min, r_max, n_bins, same) -> (n_bins,
    n_bins) uint64 counts``: the bar the SDF calculator is held to."""
    lib = _native_library("sdf_kernel")
    lib.sdf_hist_f32.restype = ctypes.c_int64
    lib.sdf_hist_f32.argtypes = [_F32, _F32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _F32,
                                 ctypes.c_float, ctypes.c_float, ctypes.c_int32, ctypes.c_int32,
                                 ctypes.POINTER(ctypes.c_uint64)]

    def run(pos_a, pos_b, box, r_min, r_max, n_bins, same):
        pa = np.ascontiguousarray(pos_a, np.float32)
        pb = np.ascontiguousarray(pos_b, np.float32)
        box = np.ascontiguousarray(box, np.float32)
        out = np.zeros((n_bins, n_bins), np.uint64)
        rc = lib.sdf_hist_f32(pa.ctypes.data_as(_F32), pb.ctypes.data_as(_F32), pa.shape[0], pa.shape[1],
                              pb.shape[1], box.ctypes.data_as(_F32), r_min, r_max, n_bins, int(same),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
        if rc != 0:
            raise RuntimeError(f"native SDF kernel returned {rc}")
        return out

    return run


def make_case(counts, n_frames, box, seed, device):
    """Seeded positions (F, Npad, 3) float32 and ids (Npad,) int32, on ``device``."""
    from lammps_analysis_tpu_torch.ops.rdf import build_species_layout

    sid, n_pad, _, _, _ = build_species_layout(counts, pad_to=8)
    rng = np.random.default_rng(seed)
    n_total = sum(counts)
    pos = np.zeros((n_frames, n_pad, 3), np.float32)
    pos[:, :n_total] = rng.uniform(0.0, 1.0, (n_frames, n_total, 3)) * np.asarray(box)
    return torch.from_numpy(pos).to(device), torch.from_numpy(sid).to(device)


def device_ms(fn, reps: int, record: str, parts=None, present_only=False) -> float:
    """Mean device milliseconds per call of a kernel record's device kernels
    (``DEVICE_KERNELS``, or those whose names hold one of ``parts``), from
    ``torch.profiler`` over ``reps`` calls after a warm-up call: the kernels'
    own time, free of the host's launch cost, memsets and gaps. The profiler
    sometimes records no device event for a window: a window that misses a
    part is profiled again, twice; after that a part it never saw raises,
    unless ``present_only``, and a record it saw nothing of is timed with CUDA
    events around back-to-back calls (``time_ms``, launch cost included):
    an ``EventMs``, which the line printed and the kernels line's
    ``"timing"`` say."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # per kernel of the record: its mean over the launches the profiler saw
        # (it may miss the first ones of a window)
        total_us, missing = 0.0, []
        for part in parts or DEVICE_KERNELS[record]:
            spans = [
                e.time_range.end - e.time_range.start
                for e in prof.events()
                if e.device_type == DeviceType.CUDA and part in e.name
            ]
            if not spans:
                missing.append(part)
                continue
            total_us += sum(spans) / len(spans)
        if not missing or (present_only and total_us > 0.0):
            return total_us / 1e3
    if total_us == 0.0:
        ms = time_ms(fn, reps)
        phase("2 timing", f"the profiler recorded no device event of {record} in 3 windows; "
              f"{ms:.4f} ms a call from CUDA events around {reps} back-to-back calls instead")
        return EventMs(ms)
    raise RuntimeError(f"the profiler saw no {missing} kernel of {record} in 3 windows")


class EventMs(float):
    """Milliseconds a call from CUDA events around back-to-back calls, launch
    cost included, where the profiler saw no device time (``device_ms``)."""


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """Least milliseconds the card needs: the larger of the float32 operations
    over the float32 peak and the bytes moved over the memory rate."""
    by_ops, by_bytes = flops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_HBM_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def sweep_floor(tests: float) -> float:
    """The sweep kernel's own floor in milliseconds: the distance tests it
    makes (every center against every atom of its range), ~22 float32
    operations each, over the float32 peak. Beside the function's bound,
    which counts only the tests a 27-cell neighborhood needs."""
    return 22 * tests / PEAK_FP32_FLOPS * 1e3


def kernel_vs_plain() -> dict:
    from lammps_analysis_tpu_torch.ops import rdf_kernel
    from lammps_analysis_tpu_torch.ops.rdf import rdf_histogram_reference

    cases = {
        "a bench 4x10240": dict(BENCH, n_frames=4, mode="shared4", reps=(20, 3)),
        "b ragged 3 species N=1000": dict(
            counts=[400, 350, 245], box=(30.0, 33.0, 36.0), cutoff=9.9, n_bins=75,
            n_frames=3, mode="warp", reps=(20, 3),
        ),
        "c global atomics 4 species x 6000 bins": dict(
            counts=[500, 500, 500, 500], box=(30.0, 30.0, 30.0), cutoff=14.9,
            n_bins=6000, n_frames=2, mode="global", reps=(10, 3),
        ),
        "e block histogram 2 species x 5000 bins": dict(
            BENCH, n_bins=5000, n_frames=2, mode="block", reps=(10, 2),
        ),
        "m main path 64x10240": dict(BENCH, n_frames=64, mode="shared4", reps=(5, 2)),
        "l LJ 32x32000, 1 species x 5709 bins": dict(LJ, n_frames=32, mode="block", reps=(5, 1)),
    }
    device = torch.device("cuda")
    results = {}
    for seed, (label, c) in enumerate(cases.items()):
        pos, sid = make_case(c["counts"], c["n_frames"], c["box"], seed, device)
        n_species = len(c["counts"])
        args = (pos, sid, c["box"], c["cutoff"], c["n_bins"], n_species)
        layout = rdf_kernel.histogram_layout(n_species, c["n_bins"])
        mode = layout.mode
        if mode != c["mode"]:
            raise RuntimeError(f"case {label}: expected the {c['mode']} histogram, got {mode}")
        h_kernel = rdf_kernel.rdf_histogram(*args)
        h_plain = rdf_histogram_reference(*args)
        torch.cuda.synchronize()
        max_diff = int((h_kernel - h_plain).abs().max())
        total = int(h_kernel.sum())
        if max_diff != 0 or total != int(h_plain.sum()) or total == 0:
            raise RuntimeError(
                f"case {label}: kernel disagrees with the plain version "
                f"(max |diff| {max_diff}, totals {total} vs {int(h_plain.sum())})"
            )
        ms = device_ms(lambda: rdf_kernel.rdf_histogram(*args), c["reps"][0], "rdf_histogram")
        plain_ms = time_ms(lambda: rdf_histogram_reference(*args), c["reps"][1])
        n_atoms, n_valid = pos.shape[1], sum(c["counts"])
        pairs = c["n_frames"] * n_valid * (n_valid - 1) / 2
        # ~22 float32 operations a pair (3 differences, 3 minimum images of 4,
        # the sum of squares, the compare), 2 more a kept pair (sqrt, bin)
        flops = 22 * pairs + 2 * total
        n_bytes = c["n_frames"] * n_atoms * 12 + n_atoms * 4 + h_kernel.numel() * 8
        bound_ms, bound_by = bound(flops, n_bytes)
        phase(
            "2 kernel",
            f"{label}: {mode} histogram ({layout.blocks_per_sm} blocks, "
            f"{8 * layout.blocks_per_sm} warps an SM), total {total}, max |diff| {max_diff}, kernel "
            f"{ms:.3f} ms ({pairs / ms / 1e6:.2f} Gpairs/s), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}; {100 * bound_ms / ms:.1f} % of it)",
        )
        results[label] = dict(max_diff=max_diff, ms=ms, plain_ms=plain_ms,
                              bound_ms=bound_ms, bound_by=bound_by)
        if label == "m main path 64x10240":
            results[label]["native_ms"] = native_rdf_bar(args, h_kernel)
        del pos, sid, h_kernel, h_plain
        torch.cuda.empty_cache()
    return results


def native_rdf_bar(args, h_kernel) -> float:
    """``[2 kernel]``: the native CPU RDF kernel (``native/rdf_kernel.cpp``,
    one thread) on the main-path launch's inputs, one call's wall, held to
    K1: the same total within a count per 10^6, and counts that differ only
    where the two bin a distance at a float32 bin edge (summed |diff| within
    10^-4 of the total; the native kernel multiplies by ``n_bins / cutoff``
    and tests ``cutoff**2``, K1 multiplies by its own reciprocals and tests
    the exact threshold)."""
    pos, sid, box, cutoff, n_bins, n_species = args
    native = native_rdf()
    pos_host, sid_host = pos.cpu().numpy(), sid.cpu().numpy()
    t0 = time.perf_counter()
    h_native = native(pos_host, sid_host, box, cutoff, n_bins, n_species)
    native_ms = (time.perf_counter() - t0) * 1e3
    ours = h_kernel.cpu().numpy()
    total, moved = int(ours.sum()), int(np.abs(h_native - ours).sum())
    if abs(int(h_native.sum()) - total) > total // 10**6 or moved > total // 10**4:
        raise RuntimeError(
            f"native RDF bar: totals {int(h_native.sum())} vs K1's {total}, summed |diff| {moved}"
        )
    phase("2 kernel", f"native CPU RDF bar (native/rdf_kernel.cpp, one thread) at {pos.shape[0]} x "
          f"{pos.shape[1]} atoms: {native_ms:.1f} ms a call, total {int(h_native.sum())} against "
          f"K1's {total}, summed |diff| {moved} (bin edges)")
    return native_ms


def hist_disagreement(ours, plain) -> tuple[float, int, float]:
    """(relative error of the total, bins outside rtol 1e-4, max |diff|)."""
    ours = np.asarray(ours, np.float64)
    plain = np.asarray(plain, np.float64)
    total = abs(ours.sum() - plain.sum()) / max(abs(plain.sum()), 1e-300)
    bad = int((~np.isclose(ours, plain, rtol=1e-4, atol=1e-6)).sum())
    return float(total), bad, float(np.abs(ours - plain).max())


def check_hist(label: str, ours, plain) -> float:
    """Hold an angle histogram to the ADF tolerance; its max |diff|."""
    total, bad, max_diff = hist_disagreement(ours, plain)
    allowed = max(2, np.asarray(plain).size // 64)
    if not np.asarray(plain).sum() > 0 or total > 1e-5 or bad > allowed:
        raise RuntimeError(
            f"{label}: angle histograms disagree (total rel err {total:.3g}, "
            f"{bad} bins outside rtol 1e-4, {allowed} allowed)"
        )
    return max_diff


def place(pos, box, layout):
    """Move atoms as a case's layout asks: ``faces`` puts a third of them on
    x = a multiple of 3.6 A and two at exactly (L, L, L); ``unwrapped``
    moves a third by (+L, -2L, +2L) and a fifth by -L."""
    edges = torch.tensor(box, device=pos.device)
    if layout == "faces":
        pos[:, ::3, 0] = torch.floor(pos[:, ::3, 0] / 3.6) * np.float32(3.6)
        pos[:, :2] = edges
    elif layout == "unwrapped":
        pos[:, ::3] += torch.tensor([1.0, -2.0, 2.0], device=pos.device) * edges
        pos[:, 1::5] -= edges


def needed_tests(pos, sid, box, cutoff, n_species, centers=None) -> int:
    """Distance tests the neighbor extract needs on these inputs: for every
    cell, its centers (those of the stripe ``centers``, else every atom)
    times the atoms of its 27 neighbor cells; every center against every
    atom when the box holds fewer than three cells on some axis."""
    from lammps_analysis_tpu_torch.ops import cells

    f, n_atoms, _ = pos.shape
    c0, c1 = centers or (0, n_atoms)
    if not cells.cell_lists_applicable(box, cutoff):
        return f * (c1 - c0) * n_atoms
    n = cells.cells_per_axis(box, cutoff)
    cell = cells.cell_of_atoms(pos, sid, box, n, n_species)
    occ = cells.cell_occupancy(cell, int(np.prod(n)))[:, :-1]
    occ_c = cells.cell_occupancy(cell[:, c0:c1].contiguous(), int(np.prod(n)))[:, :-1]
    hood = torch.from_numpy(cells.neighbor_cells(n)).to(pos.device)
    return int((occ_c * occ[:, hood].sum(-1)).sum())


def extract_bound(pos, sid, box, cutoff, n_species, k_n, counts, centers=None, idx=False):
    """The neighbor extract's bound, one for every route: the function's
    work, not a route's (for a stripe, its centers' tests and rows; with
    ``idx``, 4 more bytes a slot)."""
    f, n, _ = pos.shape
    c0, c1 = centers or (0, n)
    tests = needed_tests(pos, sid, box, cutoff, n_species, centers)
    # ~22 float32 operations a test (as the RDF's), the square root of a kept one
    flops = 22 * tests + int(counts.sum())
    n_bytes = f * n * 12 + n * 4 + f * (c1 - c0) * (k_n * (24 if idx else 20) + 4)
    return bound(flops, n_bytes)


def open_needed_tests(pos, cutoff) -> int:
    """Distance tests the extract needs with open boundaries: for every cell
    of a grid of cutoff-wide cells over the atoms' bounding box, its atoms
    times the atoms of its (up to 27) neighbor cells, nothing wrapping."""
    f, n, _ = pos.shape
    total = 0
    for fr in range(f):
        p = pos[fr].double()
        lo = p.min(0).values
        dims = torch.clamp(torch.floor((p.max(0).values - lo) / cutoff), min=1).long() + 1
        cell = torch.minimum(torch.floor((p - lo) / cutoff).long(), dims - 1)
        occ = torch.zeros(tuple(dims.tolist()), dtype=torch.float64, device=pos.device)
        occ.index_put_(tuple(cell.T), torch.ones(n, dtype=torch.float64, device=pos.device),
                       accumulate=True)
        hood = torch.nn.functional.conv3d(occ[None, None], torch.ones((1, 1, 3, 3, 3), dtype=torch.float64,
                                          device=pos.device), padding=1)[0, 0]
        total += int((occ * hood).sum())
    return total


def droplet(n_frames, seed, device):
    """``DROPLET``: atoms uniform in a sphere (no box), Na first, and their ids."""
    c = DROPLET
    n = sum(c["counts"])
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_frames, n, 3))
    v *= (c["radius"] * rng.uniform(0, 1, (n_frames, n, 1)) ** (1 / 3)) / np.linalg.norm(v, axis=-1, keepdims=True)
    sid = np.repeat(np.arange(2), c["counts"]).astype(np.int32)
    return (torch.from_numpy(v.astype(np.float32)).to(device), torch.from_numpy(sid).to(device))


def by_displacement(lists, counts):
    """``(rx, ry, rz, d, sid)`` with each row's listed slots ordered by
    (rx, ry, rz), empty slots last: a form in which two extracts with the same
    neighbor sets are equal whatever their slot order."""
    rx, ry, rz = lists[:3]
    listed = torch.arange(rx.shape[2], device=rx.device) < counts.clamp(max=rx.shape[2])[..., None]
    order = None
    for key in (rz, ry, rx):  # stable sorts, least significant key first
        k = torch.where(listed, key, torch.inf)
        k = k if order is None else torch.gather(k, 2, order)
        step = torch.sort(k, dim=2, stable=True).indices
        order = step if order is None else torch.gather(order, 2, step)
    return [torch.gather(t, 2, order) for t in lists[:5]]


def stripes_of(n: int, parts: int) -> list:
    """``[lo, hi)`` of each of ``parts`` stripes of ``n``, as
    ``parallel/mesh.py::data_sharding`` cuts them (the remainder to the
    leading stripes)."""
    base, extra = divmod(n, parts)
    edges = [0]
    for r in range(parts):
        edges.append(edges[-1] + base + (1 if r < extra else 0))
    return list(zip(edges[:-1], edges[1:]))


def kernel_rows() -> dict:
    """``[2 kernel]`` K1's i-row range on one rank's launch of the 2-D RDF of
    ``[5 mesh]`` (32 frames x 10240 atoms, the bench case): the stripes of 2
    and of 4 each equal the plain version with the same rows and add up to the
    full launch bit for bit; each stripe's device time, pairs and bound (the
    global triangle makes the first stripe the heaviest). Returns the record
    of the first of two stripes (rank 0's share on a (2, 2) mesh)."""
    from lammps_analysis_tpu_torch.ops import rdf_kernel
    from lammps_analysis_tpu_torch.ops.rdf import rdf_histogram_reference

    device = torch.device("cuda")
    n_frames = 32
    pos, sid = make_case(BENCH["counts"], n_frames, BENCH["box"], 41, device)
    args = (pos, sid, BENCH["box"], BENCH["cutoff"], BENCH["n_bins"], 2)
    full = rdf_kernel.rdf_histogram(*args)
    n = pos.shape[1]
    record = None
    for parts in (2, 4):
        total = torch.zeros_like(full)
        line = []
        for lo, hi in stripes_of(n, parts):
            ours = rdf_kernel.rdf_histogram(*args, rows=(lo, hi))
            plain = rdf_histogram_reference(*args, rows=(lo, hi))
            torch.cuda.synchronize()
            if not torch.equal(ours, plain):
                raise RuntimeError(f"K1 rows {lo}-{hi}: the kernel differs from the plain version")
            total += ours
            ms = device_ms(lambda: rdf_kernel.rdf_histogram(*args, rows=(lo, hi)), 5, "rdf_histogram")
            pairs = n_frames * ((hi - lo) * (n - 1) - (hi * (hi - 1) - lo * (lo - 1)) // 2)
            bound_ms, bound_by = bound(22 * pairs + 2 * int(ours.sum()),
                                       n_frames * n * 12 + n * 4 + ours.numel() * 8)
            line.append(f"rows {lo}-{hi} {ms:.3f} ms ({pairs / 1e9:.3f} G pairs, bound {bound_ms:.3f} ms)")
            if record is None:
                plain_ms = time_ms(lambda: rdf_histogram_reference(*args, rows=(lo, hi)), 1)
                record = dict(max_diff=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by, last_ms=None)
            if parts == 2:
                record["last_ms"] = ms
        if not torch.equal(total, full):
            raise RuntimeError(f"K1 rows: {parts} stripes do not add up to the full launch")
        phase("2 kernel", f"K1 row range, {parts} stripes of {n_frames} x {n} atoms (bench case): each "
              f"equal to the plain version, their sum equal to the full launch bit for bit; "
              + "; ".join(line))
    phase("2 kernel", f"K1 row range: the first of 2 stripes takes {record['ms']:.3f} ms, the second "
          f"{record['last_ms']:.3f} ms ({record['ms'] / record['last_ms']:.2f} x: the triangle's "
          f"imbalance, not rebalanced); plain {record['plain_ms']:.3f} ms for the first")
    return record


def extract_stripes() -> dict:
    """``[2 extract]`` K2's center stripe on both routes, on one rank's launch
    of the 2-D ADF of ``[5 mesh]`` (8 frames x 10240 atoms, first shell):
    stripes of 1, 2 and 4 each equal the plain version with the same centers
    and the rows of the full launch (all six outputs); the first of two
    stripes timed on each route with its bound. Returns its records by
    route."""
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import neighbor_extract_reference
    from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfPlan

    routes = {"binned": adf_kernel.neighbor_extract_binned, "sweep": adf_kernel.neighbor_extract_sweep}
    device = torch.device("cuda")
    pos, sid = make_case(ADF["counts"], 8, ADF["box"], 42, device)
    n = pos.shape[1]
    k_n = AdfPlan(n, ADF["box"], ADF["cutoff"]).k_n
    args = (pos, sid, ADF["box"], ADF["cutoff"], k_n, 2)
    records = {}
    for route, extract in routes.items():
        full = extract(*args)
        for parts in (1, 2, 4):
            for lo, hi in stripes_of(n, parts):
                ours = extract(*args, centers=(lo, hi))
                plain = neighbor_extract_reference(*args, centers=(lo, hi))
                torch.cuda.synchronize()
                for name, a, b, c in zip(("rx", "ry", "rz", "d", "sid", "counts"), ours, plain, full):
                    if not (torch.equal(a, b) and torch.equal(a, c[:, lo:hi])):
                        raise RuntimeError(f"K2 {route} stripe {lo}-{hi}: {name} differs from the plain "
                                           "version or the full launch")
        (lo, hi), _ = stripes_of(n, 2)
        counts = full[5][:, lo:hi]
        ms = device_ms(lambda: extract(*args, centers=(lo, hi)), 20, RECORD_OF_ROUTE[route])
        full_ms = device_ms(lambda: extract(*args), 20, RECORD_OF_ROUTE[route])
        plain_ms = time_ms(lambda: neighbor_extract_reference(*args, centers=(lo, hi)), 1)
        bound_ms, bound_by = extract_bound(pos, sid, ADF["box"], ADF["cutoff"], 2, k_n, counts, (lo, hi))
        records[route] = dict(max_diff=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        floor = ""
        if route == "sweep":
            records[route]["floor_ms"] = sweep_floor(pos.shape[0] * (hi - lo) * n)
            floor = (f", the sweep's test floor {records[route]['floor_ms']:.4f} ms "
                     f"({100 * records[route]['floor_ms'] / ms:.1f} % of it)")
        phase("2 extract", f"center stripes, {route}: stripes of 1, 2 and 4 of 8 x {n} atoms at K={k_n} "
              f"each equal to the plain version and to the rows of the full launch (all six outputs); "
              f"the first of 2 stripes {ms:.4f} ms on the device against the full launch's "
              f"{full_ms:.4f} ms ({ms / full_ms:.2f} x), bound {bound_ms:.4f} ms ({bound_by}; "
              f"{100 * bound_ms / ms:.1f} % of it){floor}, plain {plain_ms:.3f} ms")
    return records


def extract_modes() -> dict:
    """``[2 extract]`` K2's modes: the ``idx`` output on both routes (16 x
    10240, first shell) and open boundaries on the sweep (2 frames of the
    10240-atom droplet, with idx), all outputs equal to the plain versions
    bit for bit; the sorted route, z and brick, at the wide-list shape (2 x
    32768 atoms, 64 A box, cutoff 10 A, K = 1024): equal to the plain sorted
    extract bit for bit (lists, ``sid_sorted``, no overflow under the sort's
    bound), each atom's neighbor set equal to the sweep's, the windows' widest
    block against the bound; device times beside the sweep's and one bound.
    Returns the records by mode."""
    from lammps_analysis_tpu_torch.ops import adf_kernel, sorting
    from lammps_analysis_tpu_torch.ops.adf import (
        neighbor_extract_reference,
        sorted_neighbor_extract_reference,
    )
    from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfPlan

    device = torch.device("cuda")
    records = {}
    pos, sid = make_case(ADF["counts"], 16, ADF["box"], 80, device)
    k_n = AdfPlan(pos.shape[1], ADF["box"], ADF["cutoff"]).k_n
    args = (pos, sid, ADF["box"], ADF["cutoff"], k_n, 2)
    plain = neighbor_extract_reference(*args, with_idx=True)
    plain_ms = time_ms(lambda: neighbor_extract_reference(*args, with_idx=True), 1)
    for route, wrapper in (("binned", adf_kernel.neighbor_extract_binned),
                           ("sweep", adf_kernel.neighbor_extract_sweep)):
        ours = wrapper(*args, with_idx=True)
        torch.cuda.synchronize()
        for name, a, b in zip(("rx", "ry", "rz", "d", "sid", "counts", "idx"), ours, plain):
            if not torch.equal(a, b):
                raise RuntimeError(f"K2 idx, {route}: {name} differs from the plain version")
        del ours
        record = RECORD_OF_ROUTE[route]
        ms = device_ms(lambda: wrapper(*args, with_idx=True), 20, record)
        lean_ms = device_ms(lambda: wrapper(*args), 20, record)
        bound_ms, bound_by = extract_bound(pos, sid, ADF["box"], ADF["cutoff"], 2, k_n, plain[5],
                                           idx=True)
        records[f"{record} idx"] = dict(max_diff=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                        bound_by=bound_by)
        floor = ""
        if route == "sweep":
            records[f"{record} idx"]["floor_ms"] = f_ms = sweep_floor(pos.shape[0] * pos.shape[1] ** 2)
            floor = f"; the sweep's test floor {f_ms:.4f} ms ({100 * f_ms / ms:.1f} % of it)"
        phase("2 extract", f"idx, {route}: 16 x {pos.shape[1]} atoms at K={k_n}, all seven outputs equal "
              f"to the plain version; {ms:.4f} ms on the device with idx, {lean_ms:.4f} ms without; bound "
              f"{bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f} % of it){floor}; plain {plain_ms:.3f} ms")
    del plain

    pos, sid = droplet(2, 82, device)
    c = DROPLET
    args = (pos, sid, None, c["cutoff"], c["k_n"], 2)
    plain = neighbor_extract_reference(*args, with_idx=True)
    ours = adf_kernel.neighbor_extract_sweep(*args, with_idx=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("rx", "ry", "rz", "d", "sid", "counts", "idx"), ours, plain):
        if not torch.equal(a, b):
            raise RuntimeError(f"K2 open boundaries: {name} differs from the plain version")
    ms = device_ms(lambda: adf_kernel.neighbor_extract_sweep(*args), 20, "adf_neighbor_extract")
    plain_ms = time_ms(lambda: neighbor_extract_reference(*args), 1)
    tests = open_needed_tests(pos, c["cutoff"])
    n = pos.shape[1]
    bound_ms, bound_by = bound(22 * tests + int(plain[5].sum()), 2 * n * 12 + n * 4 + 2 * n * (c["k_n"] * 20 + 4))
    floor_ms = sweep_floor(2 * n * n)
    records["adf_neighbor_extract open"] = dict(max_diff=0.0, ms=ms, plain_ms=plain_ms,
                                               bound_ms=bound_ms, bound_by=bound_by, floor_ms=floor_ms)
    phase("2 extract", f"open boundaries, sweep: a droplet of 2 x {n} atoms (radius {c['radius']} A, no box), "
          f"K={c['k_n']}, mean count {float(plain[5].float().mean()):.2f}, largest {int(plain[5].max())}; "
          f"all seven outputs equal to the plain version; {ms:.4f} ms on the device, bound {bound_ms:.4f} ms "
          f"({bound_by}, {tests / 1e6:.1f} M tests in 27 cells; {100 * bound_ms / ms:.1f} % of it), the "
          f"sweep's test floor {floor_ms:.4f} ms ({100 * floor_ms / ms:.1f} % of it); plain {plain_ms:.3f} ms")
    del plain, ours

    c = WIDE
    pos, sid = make_case(c["counts"], 2, c["box"], 83, device)
    n = pos.shape[1]
    args = (pos, sid, c["box"], c["cutoff"], c["k_n"], 2)
    route = adf_kernel.extract_route(c["box"], c["cutoff"], c["k_n"], n)
    if route != "sorted" or adf_kernel.sort_for(n) != "brick":
        raise RuntimeError(f"wide lists: extract_route takes {route}, sort {adf_kernel.sort_for(n)}")
    *swept, counts = adf_kernel.neighbor_extract_sweep(*args)
    if int(counts.max()) > c["k_n"]:
        raise RuntimeError(f"wide lists saturate K={c['k_n']}: {int(counts.max())}")
    reference = by_displacement(swept, counts)
    del swept
    sweep_ms = device_ms(lambda: adf_kernel.neighbor_extract_sweep(*args), 3, "adf_neighbor_extract")
    bound_ms, bound_by = extract_bound(pos, sid, c["box"], c["cutoff"], 2, c["k_n"], counts)
    line = []
    for sort in ("z", "brick"):
        limit = sorting.window_bound(sort, n, c["box"], c["cutoff"])
        ours = adf_kernel.sorted_neighbor_extract(*args, sort, limit)
        plain = sorted_neighbor_extract_reference(*args, sort)
        torch.cuda.synchronize()
        for name, a, b in zip(("rx", "ry", "rz", "d", "sid", "counts", "sid_sorted"), ours, plain):
            if not torch.equal(a, b):
                raise RuntimeError(f"K2 sorted {sort}: {name} differs from the plain version")
        if int(ours[7]) != 0:
            raise RuntimeError(f"K2 sorted {sort}: the windows overflowed the bound {limit}")
        _, _, order, _, total = sorting.sort_frames(pos, sid, 2, c["box"], c["cutoff"], sort)
        inv = torch.argsort(order, dim=1)
        back = [torch.gather(t, 1, inv[..., None].expand_as(t)) for t in ours[:5]]
        counts_back = torch.gather(ours[5], 1, inv)
        if not torch.equal(counts_back, counts) or not all(
                torch.equal(a, b) for a, b in zip(by_displacement(back, counts_back), reference)):
            raise RuntimeError(f"K2 sorted {sort}: the neighbor sets differ from the sweep's")
        del ours, plain, back
        ms = device_ms(lambda: adf_kernel.sorted_neighbor_extract(*args, sort, limit), 3,
                       "adf_neighbor_extract")
        call_ms = time_ms(lambda: adf_kernel.sorted_neighbor_extract(*args, sort, limit), 3)
        plain_ms = time_ms(lambda: sorted_neighbor_extract_reference(*args, sort), 1)
        n_chunks = -(-n // sorting.CHUNK_ATOMS)
        floor_ms = sweep_floor(window_tests(total, n))
        records[f"adf_neighbor_extract sorted {sort}"] = dict(
            max_diff=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, floor_ms=floor_ms)
        line.append(f"{sort}: kernel {ms:.4f} ms on the device ({sweep_ms / ms:.2f} x the sweep; "
                    f"{100 * bound_ms / ms:.1f} % of the bound; the windows' test floor {floor_ms:.4f} ms, "
                    f"{100 * floor_ms / ms:.1f} % of it), "
                    f"{call_ms:.4f} ms a call with the sort and the windows, widest window "
                    f"{int(total.max())} of {n_chunks} chunks (mean {float(total.float().mean()):.1f}, "
                    f"bound {limit}), plain {plain_ms:.3f} ms")
    phase("2 extract", f"sorted route at the wide-list shape, 2 x {n} atoms, box {c['box'][0]} A, cutoff "
          f"{c['cutoff']} A, K={c['k_n']}, mean count {float(counts.float().mean()):.1f}, largest "
          f"{int(counts.max())}: each sort equal to the plain sorted extract bit for bit, no overflow, "
          f"every atom's neighbor set equal to the sweep's; sweep {sweep_ms:.4f} ms on the device; "
          + "; ".join(line) + f"; bound {bound_ms:.4f} ms ({bound_by}); extract_route takes {route}")
    del reference
    torch.cuda.empty_cache()
    return records


def window_tests(total, n_atoms: int) -> int:
    """Distance tests of the window mode: each group of ``BLOCK_CENTERS``
    sorted centers against the atoms of its window (``total``: chunks a
    group covers, ``(F * groups,)``)."""
    from lammps_analysis_tpu_torch.ops import sorting

    groups = -(-n_atoms // sorting.BLOCK_CENTERS)
    centers = torch.full((groups,), sorting.BLOCK_CENTERS, dtype=torch.int64)
    centers[-1] = n_atoms - sorting.BLOCK_CENTERS * (groups - 1)
    atoms = torch.clamp(total.view(-1, groups).cpu().long() * sorting.CHUNK_ATOMS, max=n_atoms)
    return int((atoms * centers).sum())


def pairs_bound(sid_n, counts, sid_c, n_species, n_hist):
    """``(angles, (bound ms, set by))`` of the angle histogram on these
    lists: the pairs whose angle the function needs (both neighbors of a
    species at least the center's), ~30 float32 operations each (the dot
    product, the division, acos, the bin and the weight), a species test for
    every other listed pair; each list slot, count and id read once, the
    histogram written once."""
    n_frames, n_atoms, k_n = sid_n.shape
    listed = torch.arange(k_n, device=sid_n.device) < counts.clamp(max=k_n)[..., None]
    centers = torch.where((sid_c >= 0) & (sid_c < n_species), sid_c, n_species)
    usable = listed & (sid_n >= centers[None, :, None]) & (sid_n < n_species)
    kept = usable.sum(-1, dtype=torch.float64)
    angles = float((kept * (kept - 1) / 2).sum())
    n_listed = counts.clamp(max=k_n).double()
    tests = float((n_listed * (n_listed - 1) / 2).sum()) - angles
    n_bytes = float(n_listed.sum()) * 20 + n_frames * n_atoms * 4 + n_atoms * 4 + n_hist * 4
    return angles, bound(30 * angles + 2 * tests, n_bytes)


def describe_route(route) -> str:
    """One ``[2 angles]`` route: the histogram's place and the work split."""
    return (
        f"{route.histogram} histogram, {route.chunks_per_center} chunk(s) of "
        f"{route.chunk_pairs} pairs a center, {route.blocks_per_frame} blocks x "
        f"{route.warps_per_block} warps a frame"
    )


def main_path_lists(n_frames, device):
    """Neighbor lists of the ADF main path's frames (10240 atoms, 3.6 A, K
    from ``AdfPlan``) through the routed extract."""
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfPlan

    pos, sid = make_case(ADF["counts"], n_frames, ADF["box"], 10, device)
    k_n = AdfPlan(pos.shape[1], ADF["box"], ADF["cutoff"]).k_n
    *found, counts = adf_kernel.neighbor_extract(pos, sid, ADF["box"], ADF["cutoff"], k_n, 2)
    if int(counts.max()) > k_n:
        raise RuntimeError(f"main-path lists saturate K={k_n}")
    return found, counts, sid, 2


def mixed_widths_lists(device):
    """One main-path frame whose first 400 atoms sit in a 3 A cube: most
    centers have ~31 neighbors, the cube's several hundred; K fits the
    widest."""
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import neighbor_extract_reference

    pos, sid = make_case(ADF["counts"], 1, ADF["box"], 60, device)
    rng = np.random.default_rng(61)
    pos[0, :400] = torch.from_numpy(rng.uniform(20.0, 23.0, (400, 3)).astype(np.float32)).to(device)
    *_, counts = neighbor_extract_reference(pos, sid, ADF["box"], ADF["cutoff"], 1, 2)
    k_n = -(-int(counts.max()) // 8) * 8
    *found, counts = adf_kernel.neighbor_extract(pos, sid, ADF["box"], ADF["cutoff"], k_n, 2)
    return found, counts, sid, 2


def edge_lists(device, k_n=100, n_atoms=4096, n_frames=2):
    """Seeded lists whose centers have 0, 1, 2, 32, 33, K and K + 7 entries,
    neighbor ids -1 and 2 (padding for 2 species) among 0 and 1, centers of
    species -1 and 2 among 0 and 1, and some zero-length entries."""
    rng = np.random.default_rng(70)
    r = rng.normal(size=(3, n_frames, n_atoms, k_n)).astype(np.float32)
    r[:, rng.random((n_frames, n_atoms, k_n)) < 0.01] = 0.0
    dist = np.sqrt((r * r).sum(0), dtype=np.float32)
    sid_n = rng.choice(np.array([-1, 0, 1, 2], np.int32), p=[0.05, 0.45, 0.45, 0.05],
                       size=(n_frames, n_atoms, k_n))
    counts = rng.choice(np.array([0, 1, 2, 32, 33, k_n, k_n + 7], np.int32),
                        size=(n_frames, n_atoms))
    sid_c = rng.choice(np.array([-1, 0, 1, 2], np.int32), p=[0.05, 0.45, 0.45, 0.05], size=n_atoms)
    lists = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (*r, dist, sid_n)]
    return lists, torch.from_numpy(counts).to(device), torch.from_numpy(sid_c).to(device), 2


def adf_kernels_vs_plain(angles: bool = True) -> dict:
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import (
        adf_pairs_histogram_reference,
        neighbor_extract_reference,
    )
    from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfPlan

    routes = {"binned": adf_kernel.neighbor_extract_binned, "sweep": adf_kernel.neighbor_extract_sweep}
    both = ("binned", "sweep")
    d_box = 40.0 * 6.4 ** (1 / 3)  # 65536 atoms at the 10240-atom density
    extract_cases = {
        "a1 main-path launch 1x10240": dict(ADF, n_frames=1, routes=both, reps=(50, 3)),
        "a first shell 16x10240": dict(ADF, n_frames=16, routes=both, reps=(20, 2)),
        "b 3 species N=1000, padding, id >= S": dict(
            counts=[400, 350, 245], box=(30.0, 33.0, 36.0), cutoff=5.9,
            n_frames=3, routes=both, reps=(20, 3),
        ),
        "c dense cluster, counts above K": dict(
            counts=[2000], box=(10.0, 10.0, 10.0), cutoff=4.9, k_n=128,
            n_frames=2, routes=("sweep",), reps=(10, 2),
        ),
        "d 2x65536": dict(
            counts=[32768, 32768], box=(d_box,) * 3, cutoff=3.6, n_frames=2,
            routes=both, reps=(10, 2),
        ),
        "e L/cutoff = 10 exactly, atoms on cell faces": dict(
            counts=[3000, 3000], box=(36.0, 36.0, 36.0), cutoff=3.6, n_frames=2,
            layout="faces", routes=both, reps=(10, 2),
        ),
        "f unwrapped coordinates": dict(
            counts=[3000, 3000], box=(36.0, 36.0, 36.0), cutoff=3.6, n_frames=2,
            layout="unwrapped", routes=both, reps=(10, 2),
        ),
        "g saturated, binned": dict(
            counts=[20000], box=(30.0, 30.0, 30.0), cutoff=3.2, k_n=96, n_frames=1,
            routes=both, reps=(10, 2),
        ),
        "h dense, counts across the sweep's 32-slot lines": dict(
            counts=[4000], box=(20.0, 20.0, 20.0), cutoff=3.1, k_n=120, n_frames=2,
            routes=both, reps=(10, 2),
        ),
    }
    device = torch.device("cuda")
    lists, results = {}, {}
    for seed, (label, c) in enumerate(extract_cases.items(), start=10):
        pos, sid = make_case(c["counts"], c["n_frames"], c["box"], seed, device)
        place(pos, c["box"], c.get("layout"))
        n_species = len(c["counts"])
        if label.startswith("b"):
            sid[10:13] = n_species  # out of range: padding, as the kernel reads it
        k_n = c.get("k_n") or AdfPlan(pos.shape[1], c["box"], c["cutoff"]).k_n
        args = (pos, sid, c["box"], c["cutoff"], k_n, n_species)
        plain = neighbor_extract_reference(*args)
        counts = plain[5]
        fits = counts <= k_n
        max_count = int(counts.max())
        if max_count < 2 or (label[0] in "cg") != (max_count > k_n):
            raise RuntimeError(f"extract {label}: largest count {max_count} at K={k_n}")
        timed = {}
        for route in c["routes"]:
            ours = routes[route](*args)
            torch.cuda.synchronize()
            # a center above K: its count is exact, its slots unspecified on
            # the binned route (the sweep keeps the first K, as the plain version)
            rows = fits if route == "binned" else torch.ones_like(fits)
            for name, a, b in zip(("rx", "ry", "rz", "d", "sid"), ours, plain):
                if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a[rows], b[rows]):
                    raise RuntimeError(f"extract {label}, {route}: {name} differs from the plain version")
            if not torch.equal(ours[5], counts):
                raise RuntimeError(f"extract {label}, {route}: counts differ from the plain version")
            del ours
            record = RECORD_OF_ROUTE[route]
            ms = device_ms(lambda: routes[route](*args), c["reps"][0], record)
            call_ms = time_ms(lambda: routes[route](*args), c["reps"][0])
            timed[route] = dict(max_diff=0.0, ms=ms, call_ms=call_ms)
            if route == "sweep":
                timed[route]["floor_ms"] = sweep_floor(c["n_frames"] * pos.shape[1] ** 2)
        plain_ms = time_ms(lambda: neighbor_extract_reference(*args), c["reps"][1])
        bound_ms, bound_by = extract_bound(pos, sid, c["box"], c["cutoff"], n_species, k_n, counts)
        for t in timed.values():
            t.update(plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        chosen = adf_kernel.extract_route(c["box"], c["cutoff"], k_n, pos.shape[1])
        side = ", ".join(
            f"{r} {t['ms']:.4f} ms on the device, {t['call_ms']:.4f} ms a call back to back "
            f"({100 * bound_ms / t['ms']:.1f} % of the bound"
            + (f"; the sweep's test floor {t['floor_ms']:.4f} ms, {100 * t['floor_ms'] / t['ms']:.1f} % of it)"
               if "floor_ms" in t else ")")
            for r, t in timed.items()
        )
        phase(
            "2 extract",
            f"{label}: K={k_n}, mean count {float(counts.float().mean()):.2f}, largest "
            f"{max_count}, equal to the plain version ({'rows within K and counts' if not bool(fits.all()) else 'all six outputs'}); "
            f"{side}; bound {bound_ms:.4f} ms ({bound_by}); plain {plain_ms:.3f} ms; "
            f"extract_route takes {chosen}",
        )
        for route, t in timed.items():
            results[f"extract {route} {label}"] = t
        if label.split()[0] in ("a1", "a", "b", "c", "d"):
            lists[label.split()[0]] = (plain[:5], counts, sid, n_species)
        del plain
        torch.cuda.empty_cache()
    if not angles:
        return results

    # neighbor lists wider than 1024 (10 A box, 6 A cutoff), cut into chunks
    for key, n_atoms in (("k1", 1300), ("k2", 2000)):
        pos, sid = make_case([n_atoms], 1, (10.0,) * 3, 40 + n_atoms, device)
        *_, counts = neighbor_extract_reference(pos, sid, (10.0,) * 3, 6.0, 1, 1)
        k_n = int(counts.max())
        *found, counts = adf_kernel.neighbor_extract(pos, sid, (10.0,) * 3, 6.0, k_n, 1)
        lists[key] = (found, counts, sid, 1)
    lists["mixed"] = mixed_widths_lists(device)
    lists["many"] = main_path_lists(64, device)
    lists["edge"] = edge_lists(device)

    angle_cases = {
        "a1 main-path launch, 1 frame": ("a1", 500, 4, "shared", (50, 2)),
        "a 2 species x 500 bins, p=4": ("a", 500, 4, "shared", (20, 2)),
        "a p=0": ("a", 500, 0, "shared", (5, 1)),
        "b 10 triples x 500 bins": ("b", 500, 4, "shared", (5, 1)),
        "b global atomics, 10 triples x 6000 bins": ("b", 6000, 2, "global", (5, 1)),
        "c saturated lists": ("c", 500, 4, "shared", (5, 1)),
        "d 2x65536": ("d", 500, 4, "shared", (10, 2)),
        "k1 K > 1024": ("k1", 500, 4, "shared", (3, 1)),
        "k2 K > 1024, wider": ("k2", 500, 4, "shared", (3, 1)),
        "k3 K > 1024, 30000 bins: global histogram": ("k1", 30000, 4, "global", (3, 1)),
        "mixed widths, 1 frame": ("mixed", 500, 4, "shared", (10, 2)),
        "many frames 64x10240": ("many", 500, 4, "shared", (5, 1)),
        "m edge cases 0, 1, 2, 32, 33, K, padding": ("edge", 500, 4, "shared", (10, 2)),
    }
    for label, (key, n_bins, p, where, reps) in angle_cases.items():
        (rx, ry, rz, d, sid_n), counts, sid, n_species = lists[key]
        args = (rx, ry, rz, d, sid_n, counts, sid, n_bins, n_species, p)
        n_frames, n_atoms, k_n = rx.shape
        route = adf_kernel.pairs_histogram_route(n_species, n_bins, k_n, n_atoms, n_frames)
        if route.histogram != where:
            raise RuntimeError(f"angles {label}: expected the {where} histogram, got {route}")
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
        if key in ("a1", "k1", "k2", "mixed") and route.blocks_per_frame < n_sms:
            raise RuntimeError(f"angles {label}: {route.blocks_per_frame} blocks leave SMs of {n_sms} idle")
        ours = adf_kernel.adf_pairs_histogram(*args)
        plain = adf_pairs_histogram_reference(*args)
        torch.cuda.synchronize()
        max_diff = check_hist(f"angles {label}", ours.cpu().numpy(), plain.cpu().numpy())
        ms = device_ms(lambda: adf_kernel.adf_pairs_histogram(*args), reps[0], "adf_pairs_histogram")
        plain_ms = time_ms(lambda: adf_pairs_histogram_reference(*args), reps[1])
        pairs, (bound_ms, bound_by) = pairs_bound(sid_n, counts, sid, n_species, plain.numel())
        phase(
            "2 angles",
            f"{label}: {n_frames} x {n_atoms} at K={k_n}, largest count "
            f"{int(counts.max())}; {describe_route(route)}; total "
            f"{float(plain.double().sum()):.6g}, max |diff| {max_diff:.3g}, kernel "
            f"{ms:.4f} ms ({pairs / ms / 1e6:.2f} G pair angles/s), plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f} % of it)",
        )
        results[f"angles {label}"] = dict(max_diff=max_diff, ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound_ms, bound_by=bound_by)
    del lists
    torch.cuda.empty_cache()
    return results


def forced_calls(label: str, fn, n: int = 7) -> float:
    """Median wall milliseconds of ``n`` forced (not cached) calls on a warm
    process, host clock around each call."""
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    phase(
        "4 profile",
        f"{label}: wall per call, median of {n} {float(np.median(walls)):.3f} ms "
        f"(from {min(walls):.3f} to {max(walls):.3f} ms)",
    )
    return float(np.median(walls))


def profile_call(label: str, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler``: device time and launches per
    kernel record, the share of the call the device was busy, and the host's
    kernel launches (runtime API calls). Returns ``records`` (per kernel
    record), ``names`` (device time by kernel name, microseconds),
    ``device_ms``, ``busy`` (the busy share) and ``launches``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("profiled call"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    call = next(e for e in events if e.name == "profiled call")
    device = sorted(  # kernels, copies and fills; not the annotation itself
        (e.time_range.start, e.time_range.end, e.name)
        for e in events if e.device_type == DeviceType.CUDA and e.name != "profiled call"
    )
    busy, end = 0.0, float("-inf")
    for start, stop, _ in device:  # union of the device's busy intervals
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    wall_us = call.time_range.end - call.time_range.start
    host_launches = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                                         "cuLaunchKernel", "cuLaunchKernelEx"))
    per_record = {}
    for record, parts in DEVICE_KERNELS.items():
        spans = [(a, b) for a, b, name in device if any(part in name for part in parts)]
        if spans:
            per_record[record] = dict(
                device_ms=sum(b - a for a, b in spans) / 1e3,
                kernels=len(spans),
            )
    by_name = {}
    for start, stop, name in device:
        short = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0][-40:]
        by_name[short] = by_name.get(short, 0.0) + stop - start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    phase(
        "4 profile",
        f"{label}: device time by kernel, largest first: "
        + ", ".join(f"{name} {us / 1e3:.3f} ms" for name, us in top),
    )
    phase(
        "4 profile",
        f"{label}: {wall_us / 1e3:.3f} ms under the profiler, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} % of the call, idle "
        f"{100 - 100 * busy / wall_us:.1f} %), {host_launches} kernel launches from the host; "
        + "; ".join(
            f"{name} {v['device_ms']:.3f} ms in {v['kernels']} device kernels"
            for name, v in per_record.items()
        ),
    )
    return dict(records=per_record, names=by_name, device_ms=busy / 1e3, busy=busy / wall_us,
                launches=host_launches)


def ingest(root, counts, n_frames, box, seed, pos=None):
    """A port Project under ``root`` with experiment ``e`` of seeded Na/Cl
    (uniform in the box, or the given (F, N, 3) positions, Na first)."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database import (
        PropertyInfo, SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata,
    )
    from lammps_analysis_tpu_torch.file_io import ScriptInput

    prop = PropertyInfo("Positions", 3)
    species = [SpeciesInfo(name, n, [prop]) for name, n in zip(("Na", "Cl"), counts)]
    if pos is None:
        rng = np.random.default_rng(seed)
        pos = rng.uniform(0.0, box, (n_frames, sum(counts), 3)).astype(np.float32)
    meta = TrajectoryMetadata(
        n_configurations=n_frames, species_list=species, box_l=[box] * 3, sample_rate=1
    )
    chunk = TrajectoryChunkData(species, n_frames)
    chunk.add_data(pos[:, : counts[0]], 0, "Na", "Positions")
    chunk.add_data(pos[:, counts[0]:], 0, "Cl", "Positions")
    project = lt.Project(name="smoke", storage_path=root)
    return project.add_experiment(
        "e", timestep=0.002, temperature=1200.0, units="metal",
        simulation_data=ScriptInput(chunk, meta, "seeded"),
    )


def main_path(card: str) -> tuple[int, dict]:
    from lammps_analysis_tpu_torch import config

    config.device = "cuda"
    kw = dict(number_of_configurations=64, cutoff=BENCH["cutoff"],
              number_of_bins=BENCH["n_bins"], plot=False)
    with tempfile.TemporaryDirectory() as root:
        exp = ingest(root, BENCH["counts"], 100, BENCH["box"][0], seed=2024)
        zero_counters()
        t0 = time.perf_counter()
        result = exp.run.RadialDistributionFunction(**kw)
        seconds = time.perf_counter() - t0
        counts = mesh_counters()
        launches, plain_calls = counts["rdf_histogram"], counts["plain"]
        if launches < 1 or plain_calls != 0:
            raise RuntimeError(
                f"main path: {launches} kernel launches and {plain_calls} plain "
                "calls; it must go through the kernel alone"
            )
        for key in ("Na_Na", "Na_Cl", "Cl_Cl"):
            x_angstrom = np.asarray(result[key]["x"]) * 10.0  # nm -> A
            g = np.asarray(result[key]["y"])
            if g.shape != (BENCH["n_bins"],) or not np.all(np.isfinite(g)):
                raise RuntimeError(f"main path: g(r) of {key} has shape {g.shape} or non-finite values")
            median = float(np.median(g[(x_angstrom >= 5.0) & (x_angstrom <= BENCH["cutoff"])]))
            if abs(median - 1.0) > 0.02:
                raise RuntimeError(f"main path: {key} g(r) median {median} is not an ideal gas's 1")
            phase("3 main", f"{key}: g(r) finite, median over 5-19.9 A {median:.5f}")
        phase(
            "3 main",
            f"RDF 64 frames x 10240 atoms x 500 bins: {seconds:.3f} s wall, "
            f"{launches} kernel launches, 0 plain calls, on {card}",
        )
        again = exp.run.RadialDistributionFunction(**kw)
        if mesh_counters()["rdf_histogram"] != launches or again.data_dict != result.data_dict:
            raise RuntimeError("main path: the second run was not a cache hit")
        phase("3 main", "second run: cache hit, no new launch")
        def forced():
            return exp.run.RadialDistributionFunction(force=True, **kw)

        forced_calls("RDF 64 frames x 10240 atoms, forced", forced)
        profiled = profile_call("RDF 64 frames x 10240 atoms, forced", forced)
        orchestration_rdf(exp, kw, result, forced)

        # the post-processing over the RDF that K1 computed: the ideal gas's
        # coordination number is rho 4/3 pi (r^3 - r0^3)
        t0 = time.perf_counter()
        post = post_process(exp, result)
        post_s = time.perf_counter() - t0
        volume_nm3 = exp.volume * exp.units.volume / 1e-27
        worst = 0.0
        for key in ("Na_Na", "Na_Cl", "Cl_Cl"):
            r, cn = (np.asarray(post["CoordinationNumbers"][key][k]) for k in ("r", "cn"))
            ideal = BENCH["counts"][0] / volume_nm3 * 4 / 3 * np.pi * (r[-1] ** 3 - r[0] ** 3)
            worst = max(worst, abs(cn[-1] / ideal - 1))
        if worst > 0.02:
            raise RuntimeError(f"post: the ideal gas's coordination number is {worst:.3%} off rho 4/3 pi r^3")
        phase("3 post", f"CN, POMF, KBI and S(q) over the [3 main] RDF (K1, 64 frames x 10240 atoms) "
              f"in {post_s * 1e3:.1f} ms: every series finite, CN at 19.9 A within {worst:.3%} of the "
              "ideal gas's rho 4/3 pi r^3 (2 % allowed)")
        sdf_path(exp, card)

    # the same path on a small input, on the card and on the CPU
    small = dict(counts=[300, 200], n_frames=10, box=15.0)
    kw = dict(number_of_configurations=10, cutoff=7.4, number_of_bins=100, plot=False)
    outputs = {}
    for device in ("cuda", "cpu"):
        config.device = device
        with tempfile.TemporaryDirectory() as root:
            exp = ingest(root, small["counts"], small["n_frames"], small["box"], seed=7)
            rdf = exp.run.RadialDistributionFunction(**kw)
            outputs[device] = rdf.data_dict, post_process(exp, rdf)
    config.device = "cuda"
    if outputs["cuda"][0] != outputs["cpu"][0]:
        raise RuntimeError("main path: g(r) on the card differs from the CPU's plain path")
    phase("3 main", "small input (300 + 200 atoms, 10 frames): card and CPU g(r) identical")
    if outputs["cuda"][1] != outputs["cpu"][1]:
        raise RuntimeError("post: the post-processing of the card's RDF differs from the CPU's")
    phase("3 post", "small input: CN, POMF, KBI and S(q) of the card's and the CPU's RDF identical")
    post_lattice()
    return launches, profiled


def orchestration_rdf(exp, kw, result, forced) -> None:
    """``[3 orchestration]`` on the ``[3 main]`` RDF: ``plot=True`` (a cache
    hit) writes ``figures/RadialDistributionFunction.html`` whose panels hold
    the result's g(r), and the PNG where matplotlib imports; one forced call
    under ``utils.profiling.device_trace`` with ``annotate`` spans writes a
    Chrome trace that names K1's kernel and the spans."""
    import html as html_module
    import re

    from lammps_analysis_tpu_torch.utils import profiling
    from lammps_analysis_tpu_torch.visualizer import have_matplotlib

    t0 = time.perf_counter()
    exp.run.RadialDistributionFunction(**dict(kw, plot=True))
    plot_s = time.perf_counter() - t0
    figures = exp.path / "figures"
    page = (figures / "RadialDistributionFunction.html").read_text()
    panels = [json.loads(html_module.unescape(b)) for b in re.findall(r"data-series='([^']*)'", page)]
    for panel, key in zip(panels, ("Na_Na", "Na_Cl", "Cl_Cl")):
        y = np.asarray(result[key]["y"], float)
        if not np.array_equal(np.asarray(panel["y"]), y[np.isfinite(y)]):
            raise RuntimeError(f"orchestration: the HTML panel of {key} does not hold the result's g(r)")
    png = (figures / "RadialDistributionFunction.png").exists()
    if len(panels) != 3 or png != have_matplotlib():
        raise RuntimeError(f"orchestration: {len(panels)} panels, PNG {png}, matplotlib {have_matplotlib()}")
    phase("3 orchestration", f"plot=True on the [3 main] RDF (a cache hit): RadialDistributionFunction.html "
          f"({len(page) / 1e3:.0f} kB, 3 panels holding the result's g(r)) in {plot_s * 1e3:.1f} ms; PNG "
          f"{'written' if png else 'not written: matplotlib does not import here'}")
    with tempfile.TemporaryDirectory() as trace_dir:
        t0 = time.perf_counter()
        with profiling.device_trace(trace_dir):
            with profiling.annotate("rdf forced call"):
                forced()
        trace_s = time.perf_counter() - t0
        (trace,) = pathlib.Path(trace_dir).glob("trace-*.json")
        names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
        size_mb = trace.stat().st_size / 1e6
    if not any("rdf_histogram_kernel" in name for name in names) or "rdf forced call" not in names:
        raise RuntimeError("orchestration: the trace holds no rdf_histogram_kernel or no annotate span")
    phase("3 orchestration", f"device_trace around one forced RDF call with an annotate span: "
          f"{trace.name} ({size_mb:.1f} MB, {len(names)} event names) names rdf_histogram_kernel and "
          f"the span; {trace_s:.3f} s with the export")


def orchestration_energies(exp) -> None:
    """``[3 orchestration]``: ``exp.time_series.Energies`` on the ``[3 flux]``
    experiment (per-atom potential energies of 250 frames x 10240 atoms),
    the per-frame totals summed on the card in float64, against numpy float64
    sums of the stored arrays (rtol 1e-12), with its HTML plot."""
    from lammps_analysis_tpu_torch.utils.config import get_device

    window = 10
    if get_device().type != "cuda":
        raise RuntimeError(f"orchestration: config.device is {get_device()}")
    t0 = time.perf_counter()
    series = exp.time_series.Energies(window=window)
    seconds = time.perf_counter() - t0
    worst = 0.0
    for sp in ("Na", "Cl"):
        data = exp.store.load([f"{sp}/Potential_Energy"])[f"{sp}/Potential_Energy"].astype(np.float64)
        total = data.sum(axis=(1, 2))
        want = np.convolve(total, np.ones(window) / window, mode="valid")
        got = series["series"][sp]
        if got.shape != want.shape:
            raise RuntimeError(f"orchestration: Energies {sp} has shape {got.shape}, not {want.shape}")
        worst = max(worst, float(np.max(np.abs(got / want - 1))))
    if worst > 1e-12 or not (exp.path / "figures" / "timeseries_Potential_Energy.html").exists():
        raise RuntimeError(f"orchestration: Energies off the float64 sums by {worst} or no HTML plot")
    phase("3 orchestration", f"exp.time_series.Energies(window={window}) on the [3 flux] experiment "
          f"({len(series['time'])} points a species, sums on the card in float64): within {worst:.2e} of "
          f"numpy float64 sums of the stored arrays; timeseries_Potential_Energy.html written; "
          f"{seconds * 1e3:.1f} ms")


def sdf_path(exp, card: str) -> None:
    """``[3 sdf]``: ``SpatialDistributionFunction`` with its defaults (r 4.0-4.5
    A, 5 frames from 1-10, 100 x 100 bins) on the ``[3 main]`` ideal gas,
    Na-Cl and Na-Na: tiles on the card, counts held to the native CPU kernel,
    the total to the ideal gas's pair count in the shell and the theta
    marginal to its cos-difference shares; the peak device memory a pair of a
    tile against ``PEAK_BYTES_PER_PAIR``; ``[4 profile]`` forced-call medians."""
    from lammps_analysis_tpu_torch.calculators import spatial_distribution_function as sdf_module
    from lammps_analysis_tpu_torch.database.trajectory_store import TrajectoryStore

    native = native_sdf()
    n_na, _ = BENCH["counts"]
    box = BENCH["box"][0]
    frames = np.unique(np.linspace(1, 10, 5, dtype=int))
    r_min, r_max, n_bins = 4.0, 4.5, 100
    shell = 4 / 3 * np.pi * (r_max**3 - r_min**3)
    edges = np.linspace(0.0, np.pi, n_bins + 1)
    shares = (np.cos(edges[:-1]) - np.cos(edges[1:])) / 2
    arrays = exp.store.load(["Na/Positions", "Cl/Positions"], frames=frames)
    calculator = sdf_module.SpatialDistributionFunction(exp)
    for label, species in (("Na-Cl", ["Na", "Cl"]), ("Na-Na", ["Na"])):
        sp_b = species[-1]
        n_b = exp.species[sp_b].n_particles
        a_block, fpb = calculator.tiles(n_na, n_b, len(frames))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with Spy(sdf_module, "sdf_tile", sync=True) as tiles:
            t0 = time.perf_counter()
            result = exp.run.SpatialDistributionFunction(species=species, plot=False)
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        per_pair = peak / (fpb * a_block * n_b)
        if tiles.devices != {"cuda"} or per_pair > calculator.PEAK_BYTES_PER_PAIR:
            raise RuntimeError(f"sdf {label}: tiles on {tiles.devices}, {per_pair:.1f} bytes a pair "
                               f"(PEAK_BYTES_PER_PAIR {calculator.PEAK_BYTES_PER_PAIR})")
        hist = np.asarray(result["System"]["sdf"])
        sphere = np.asarray(result["System"]["sphere"])
        if hist.shape != (n_bins, n_bins) or sphere.shape != (n_bins, n_bins, 3) \
                or not np.isfinite(hist).all():
            raise RuntimeError(f"sdf {label}: histogram {hist.shape}, sphere {sphere.shape}")
        t0 = time.perf_counter()
        bar = native(arrays["Na/Positions"], arrays[f"{sp_b}/Positions"], [box] * 3, r_min, r_max,
                     n_bins, sp_b == "Na")
        native_s = time.perf_counter() - t0
        diff_total, diff_bins = torch_dumps.assert_counts_close(hist, bar)
        pairs = n_na * (n_na - 1) if sp_b == "Na" else n_na * n_b
        expected = len(frames) * pairs / box**3 * shell
        total = hist.sum()
        marginal = hist.sum(axis=1)
        z = np.abs(marginal - total * shares) / np.sqrt(total * shares)
        if abs(total / expected - 1) > 0.01 or z.max() > 5:
            raise RuntimeError(f"sdf {label}: {total:.0f} pairs in the shell against the ideal gas's "
                               f"{expected:.0f}, theta marginal off its shares by {z.max():.2f} sigma")
        phase("3 sdf", f"{label}: {total:.0f} pairs in 4.0-4.5 A over {len(frames)} frames, "
              f"{100 * (total / expected - 1):+.3f} % of the ideal gas's {expected:.0f}; theta "
              f"marginal within {z.max():.2f} sigma of its shares; = native CPU kernel: totals differ "
              f"by {diff_total:.0f}, bins by {diff_bins:.0f} in all; {tiles.calls} tile(s) of {fpb} "
              f"frame(s) x {a_block} x {n_b} on {tiles.devices}, peak device memory {peak / 2**30:.3f} "
              f"GiB ({per_pair:.1f} bytes a pair, PEAK_BYTES_PER_PAIR "
              f"{calculator.PEAK_BYTES_PER_PAIR}); wall {wall * 1e3:.3f} ms, native bar "
              f"{native_s * 1e3:.3f} ms on the host")

        def forced(species=species):
            return exp.run.SpatialDistributionFunction(species=species, plot=False, force=True)

        size = f"SDF {label} {len(frames)} frames x {sum(BENCH['counts'])} atoms, forced"
        forced_calls(size, forced)
        trace = profile_call(size, forced)
        span_call(size, forced, {
            "store reads": Spy(TrajectoryStore, "load"),
            "tiles on the device": Spy(sdf_module, "sdf_tile", sync=True),
        })
        phase("3 sdf", f"{label}: device time {trace['device_ms'] / len(frames):.3f} ms a frame, native "
              f"CPU kernel {native_s * 1e3 / len(frames):.3f} ms a frame, on {card}")


def post_process(exp, rdf) -> dict:
    """The four RDF post-processing calculators over ``rdf``: their data
    dicts, every value finite."""
    out = {}
    for name in POST:
        out[name] = getattr(exp.run, name)(rdf_data=rdf, plot=False).data_dict
        for subject, values in out[name].items():
            for key, v in values.items():
                if not np.all(np.isfinite(np.asarray(v, dtype=float))):
                    raise RuntimeError(f"post: {name} {subject} {key} is not finite")
    return out


def rock_salt(cells, a, n_frames, jitter, seed):
    """``(positions (F, 2 n, 3) float32, n)``: a rock-salt lattice of
    ``cells``^3 cubic cells of edge ``a``, Na on the fcc sites and Cl
    shifted by a/2, each atom jittered by a seeded Gaussian of sd
    ``jitter`` per axis in every frame."""
    fcc = np.array([[0, 0, 0], [0, 0.5, 0.5], [0.5, 0, 0.5], [0.5, 0.5, 0]])
    grid = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing="ij"), -1).reshape(-1, 1, 3)
    na = ((grid + fcc) * a).reshape(-1, 3)
    sites = np.concatenate([na, na + [a / 2, 0, 0]])
    rng = np.random.default_rng(seed)
    pos = sites + rng.normal(scale=jitter, size=(n_frames,) + sites.shape)
    return np.mod(pos, cells * a).astype(np.float32), len(na)


def post_lattice() -> None:
    """K1's RDF of a rock-salt lattice (6^3 cells of 5.64 A, 0.1 A thermal
    jitter, 8 frames) -> the post-processing finds the first shells: 6 Cl
    around Na and 12 like ions; the card's results equal the CPU's."""
    from lammps_analysis_tpu_torch import config

    cells, a, n_frames = 6, 5.64, 8
    pos, n = rock_salt(cells, a, n_frames, 0.1, seed=2032)
    kw = dict(number_of_configurations=n_frames, cutoff=8.0, number_of_bins=400, plot=False)
    outputs = {}
    for device in ("cuda", "cpu"):
        config.device = device
        with tempfile.TemporaryDirectory() as root:
            exp = ingest(root, [n, n], n_frames, cells * a, seed=0, pos=pos)
            zero_counters()
            rdf = exp.run.RadialDistributionFunction(**kw)
            outputs[device] = rdf.data_dict, post_process(exp, rdf), mesh_counters()["rdf_histogram"]
    config.device = "cuda"
    if outputs["cuda"][2] < 1 or outputs["cpu"][2] != 0:
        raise RuntimeError(f"post lattice: K1 launches card {outputs['cuda'][2]}, CPU {outputs['cpu'][2]}")
    if outputs["cuda"][:2] != outputs["cpu"][:2]:
        raise RuntimeError("post lattice: the card's RDF or post-processing differs from the CPU's")
    cn = outputs["cuda"][1]["CoordinationNumbers"]
    pomf = outputs["cuda"][1]["PotentialOfMeanForce"]
    shells = {"Na_Na": 12, "Na_Cl": 6, "Cl_Cl": 12}
    found = {k: cn[k].get("CN_1") for k in shells}
    if any(v is None or abs(v / shells[k] - 1) > 0.02 for k, v in found.items()) or any(
        "POMF_1" not in pomf[k] for k in shells
    ):
        raise RuntimeError(f"post lattice: first-shell coordination numbers {found}, expected {shells}")
    phase("3 post", f"rock-salt lattice ({2 * n} atoms, {n_frames} frames, K1 on the card): first-shell "
          "CN " + ", ".join(f"{k} {v:.4f}" for k, v in found.items()) + " (6 / 12 within 2 %), POMF_1 "
          + ", ".join(f"{k} {pomf[k]['POMF_1']:.4g} eV" for k in shells) + "; card == CPU")


def adf_main_path(card: str) -> tuple[dict, dict]:
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.memory.planner import BatchPlanner

    n_bins = ADF["n_bins"]
    d_theta = ADF_RANGE / n_bins
    theta = (np.arange(n_bins) + 0.5) * d_theta
    keys = ("Na_Na_Na", "Na_Na_Cl", "Na_Cl_Cl", "Cl_Cl_Cl")
    config.device = "cuda"
    kw = dict(number_of_configurations=16, start=0, cutoff=ADF["cutoff"],
              number_of_bins=n_bins, plot=False)
    with tempfile.TemporaryDirectory() as root:
        exp = ingest(root, ADF["counts"], 20, ADF["box"][0], seed=2025)
        calculator = exp.run.AngularDistributionFunction
        zero_counters()
        t0 = time.perf_counter()
        result = calculator(**kw)
        seconds = time.perf_counter() - t0
        counts = mesh_counters()
        launches = {name: counts[name] for name in ADF_KERNELS}
        plain_calls = counts["plain"]
        expected = {"adf_neighbor_cells": 16, "adf_neighbor_extract": 0, "adf_pairs_histogram": 16}
        if launches != expected or plain_calls != 0:
            raise RuntimeError(
                f"adf main path: kernel launches {launches} and {plain_calls} plain "
                f"calls; expected {expected} and none: the binned extract and the "
                "angle kernel alone"
            )
        n_batches = counts["adf batches"] // counts["adf passes"]
        for key in keys:
            adf = np.asarray(result[key]["adf"])
            if adf.shape != (n_bins,) or not np.all(np.isfinite(adf)):
                raise RuntimeError(f"adf main path: {key} has shape {adf.shape} or non-finite values")
            area = float(adf.sum() * d_theta)
            if abs(area - n_batches) > 1e-4 * n_batches:
                raise RuntimeError(f"adf main path: {key} integrates to {area}, not {n_batches} batches")
        phase(
            "3 adf",
            f"ADF 16 frames x 10240 atoms x 500 bins, cutoff 3.6 A: {seconds:.3f} s wall, "
            f"{n_batches} batches, K={calculator.last_k_n}, {counts['adf passes']} "
            f"pass(es), launches {launches}, 0 plain calls, "
            f"every triple finite and integrating to {n_batches}, on {card}",
        )

        ideal = exp.run.AngularDistributionFunction(norm_power=0, **kw)
        window = (theta >= 0.5) & (theta <= 2.6)
        for key in keys:
            adf = np.asarray(ideal[key]["adf"])
            ratio = float(np.median(adf[window] / (n_batches * np.sin(theta[window]) / 2)))
            if abs(ratio - 1.0) > 0.03:
                raise RuntimeError(f"adf main path: {key} at p=0 is {ratio} x sin(theta)/2")
            phase("3 adf", f"{key}, norm_power=0: median adf / (n_batches sin(theta)/2) "
                  f"over 0.5-2.6 rad {ratio:.5f}")

        before = mesh_counters()
        again = exp.run.AngularDistributionFunction(**kw)
        if mesh_counters() != before or again.data_dict != result.data_dict:
            raise RuntimeError("adf main path: the second run was not a cache hit")
        phase("3 adf", "second run: cache hit, no new launch")
        def forced():
            return exp.run.AngularDistributionFunction(force=True, **kw)

        forced_calls("ADF 16 frames x 10240 atoms, forced", forced)
        profiled = profile_call("ADF 16 frames x 10240 atoms, forced", forced)

    # the same path on a small input, on the card and on the CPU, with one
    # planner budget so both split the frames into the same batches
    kw = dict(number_of_configurations=6, start=0, cutoff=3.6, number_of_bins=100, plot=False)
    outputs = {}
    for device in ("cuda", "cpu"):
        config.device = device
        with tempfile.TemporaryDirectory() as root:
            exp = ingest(root, [300, 200], 6, 15.0, seed=8)
            exp.planner = BatchPlanner(memory_budget_bytes=2**33)
            outputs[device] = exp.run.AngularDistributionFunction(**kw).data_dict
    config.device = "cuda"
    for key in keys:
        check_hist(f"adf small input {key}", outputs["cuda"][key]["adf"], outputs["cpu"][key]["adf"])
    phase("3 adf", "small input (300 + 200 atoms, 6 frames, 3 batches): card and CPU "
          "agree within the angle-histogram tolerance")
    native_adf_bar()
    return launches, profiled


def native_adf_bar() -> float:
    """``[3 adf]``: the native CPU ADF kernel (``native/adf_kernel.cpp``, one
    thread: neighbor search and angles in one call) on 16 first-shell frames
    of 10240 atoms, one call's wall, beside ``adf_kernel.adf_histogram`` (K2
    then K3 on the card, CUDA events around back-to-back calls) on the same
    frames, held to it within the angle-histogram tolerance."""
    from lammps_analysis_tpu_torch.ops import adf_kernel

    c = ADF
    pos, sid = make_case(c["counts"], 16, c["box"], 2026, torch.device("cuda"))
    args = (pos, sid, c["box"], c["cutoff"], c["n_bins"], len(c["counts"]))
    hist, max_count = adf_kernel.adf_histogram(*args)
    card_ms = time_ms(lambda: adf_kernel.adf_histogram(*args), 10)
    native = native_adf()
    pos_host, sid_host = pos.cpu().numpy(), sid.cpu().numpy()
    t0 = time.perf_counter()
    h_native = native(pos_host, sid_host, c["box"], c["cutoff"], c["n_bins"], len(c["counts"]))
    native_ms = (time.perf_counter() - t0) * 1e3
    max_diff = check_hist("native ADF bar", hist.cpu().numpy(), h_native)
    phase("3 adf", f"native CPU ADF bar (native/adf_kernel.cpp, one thread) at 16 x 10240 atoms, "
          f"cutoff {c['cutoff']} A: {native_ms:.1f} ms a call; adf_kernel.adf_histogram (K2 + K3, "
          f"K=128, largest count {int(max_count)}) {card_ms:.3f} ms a call on the card; within "
          f"the angle-histogram tolerance (max |diff| {max_diff:.4g})")
    return native_ms


def adf_wide_path(card: str) -> dict:
    """``[3 adf-wide]``: the wide-list shapes and open boundaries through the
    entry points a user calls, on the card, with every count set to 0 just
    before and read just after:

    * ``exp.run.AngularDistributionFunction`` on 2 frames of ``WIDE`` (32768
      atoms, cutoff 10 A, 500 bins): the plan's first pass at K = 512 takes
      the binned route and saturates, the second at K = 1024 the sorted route
      (brick sort) and the angle kernel per frame; no plain call; every triple
      finite and integrating to the batch count; held to the same call with
      the sorted route turned into the sweep (the ADF allowance); forced-call
      walls of both routes; one forced call under the profiler (device busy
      and idle share);
    * ``ops.adf_kernel.adf_histogram`` one-shot on 2 x 10240 atoms at cutoff
      10 A, K = 1024 (``WIDE_Z``: the sorted route, z sort), held to the
      sweep's histogram; and on 2 frames of the droplet with ``box=None``
      (the sweep, open boundaries), held to the plain ADF;
    * ``ops.adf_kernel.neighbor_indices`` on the ``[3 adf]`` frames (binned,
      idx) and on the droplet (sweep, open, idx), equal to the plain idx.

    Returns the launches by record."""
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import adf_histogram_reference, neighbor_extract_reference
    from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfPlan

    c = WIDE
    n_bins = c["n_bins"]
    d_theta = ADF_RANGE / n_bins
    keys = ("Na_Na_Na", "Na_Na_Cl", "Na_Cl_Cl", "Cl_Cl_Cl")
    kw = dict(number_of_configurations=2, start=0, cutoff=c["cutoff"], number_of_bins=n_bins, plot=False)
    config.device = "cuda"
    route = adf_kernel.extract_route

    def sweep_for_sorted(*args):
        chosen = route(*args)
        return "sweep" if chosen == "sorted" else chosen

    with tempfile.TemporaryDirectory() as root:
        exp = ingest(root, c["counts"], 2, c["box"][0], seed=2040)
        calculator = exp.run.AngularDistributionFunction
        zero_counters()
        t0 = time.perf_counter()
        result = calculator(**kw)
        seconds = time.perf_counter() - t0
        counts = mesh_counters()
        if counts["adf_neighbor_extract sorted brick"] < 1 or counts["adf_pairs_histogram"] < 1 \
                or counts["plain"] or counts["adf_neighbor_extract sorted z"]:
            raise RuntimeError(f"adf-wide: launches {counts}; the brick-sorted route and the angle "
                               "kernel, no plain call")
        n_batches = counts["adf batches"] // counts["adf passes"]
        for key in keys:
            adf = np.asarray(result[key]["adf"])
            area = float(adf.sum() * d_theta)
            if adf.shape != (n_bins,) or not np.all(np.isfinite(adf)) or abs(area - n_batches) > 1e-4 * n_batches:
                raise RuntimeError(f"adf-wide: {key} has shape {adf.shape}, area {area}")
        launches = dict(counts)
        phase("3 adf-wide", f"ADF 2 frames x {sum(c['counts'])} atoms, box {c['box'][0]} A, cutoff "
              f"{c['cutoff']} A, {n_bins} bins: {seconds:.3f} s wall (first call), {n_batches} batch(es), "
              f"{counts['adf passes']} passes to K={calculator.last_k_n}; launches "
              f"{ {k: v for k, v in counts.items() if v} }, 0 plain calls; every triple finite and "
              f"integrating to {n_batches}, on {card}")
        adf_kernel.extract_route = sweep_for_sorted
        try:
            zero_counters()
            swept = exp.run.AngularDistributionFunction(force=True, **kw)
            sweep_counts = mesh_counters()
            sweep_wall = forced_calls("ADF wide, sweep route, forced",
                                      lambda: exp.run.AngularDistributionFunction(force=True, **kw), n=3)
            swept_profile = profile_call(
                "ADF wide 2 frames x 32768 atoms, sweep route, forced",
                lambda: exp.run.AngularDistributionFunction(force=True, **kw))
        finally:
            adf_kernel.extract_route = route
        if sweep_counts["adf_neighbor_extract sorted brick"] or sweep_counts["adf_neighbor_extract"] < 1:
            raise RuntimeError(f"adf-wide: the sweep-route call launched {sweep_counts}")
        for key in keys:
            check_hist(f"adf-wide {key} sorted vs sweep", result[key]["adf"], swept[key]["adf"])
        def forced():
            return exp.run.AngularDistributionFunction(force=True, **kw)

        sorted_wall = forced_calls("ADF wide, sorted route, forced", forced, n=3)
        profiled = profile_call("ADF wide 2 frames x 32768 atoms, sorted route, forced", forced)
        phase("3 adf-wide", f"the sorted route's ADF within the ADF allowance of the sweep route's on every "
              f"triple; forced-call medians: sorted {sorted_wall:.3f} ms, sweep {sweep_wall:.3f} ms; device "
              f"busy {100 * profiled['busy']:.1f} % of the sorted call (idle {100 - 100 * profiled['busy']:.1f} %), "
              f"{100 * swept_profile['busy']:.1f} % of the sweep's; kernel launches from the host "
              f"{profiled['launches']} and {swept_profile['launches']}")

    device = torch.device("cuda")
    zero_counters()
    cz = WIDE_Z
    pos, sid = make_case(cz["counts"], 2, cz["box"], 2041, device)
    t0 = time.perf_counter()
    hist, max_count = adf_kernel.adf_histogram(pos, sid, cz["box"], cz["cutoff"], cz["n_bins"], 2,
                                               k_n=cz["k_n"])
    torch.cuda.synchronize()
    z_s = time.perf_counter() - t0
    counts = mesh_counters()
    adf_kernel.extract_route = sweep_for_sorted
    try:
        swept, _ = adf_kernel.adf_histogram(pos, sid, cz["box"], cz["cutoff"], cz["n_bins"], 2,
                                            k_n=cz["k_n"])
    finally:
        adf_kernel.extract_route = route
    if counts["adf_neighbor_extract sorted z"] != 1 or int(max_count) > cz["k_n"]:
        raise RuntimeError(f"adf_histogram wide z: launches {counts}, largest count {int(max_count)}")
    check_hist("adf_histogram wide, z-sorted vs sweep", hist.cpu().numpy(), swept.cpu().numpy())
    phase("3 adf-wide", f"adf_histogram one-shot, 2 x {sum(cz['counts'])} atoms, cutoff {cz['cutoff']} A, "
          f"K={cz['k_n']}: the z-sorted route ({counts['adf_neighbor_extract sorted z']} launch, angle kernel "
          f"{counts['adf_pairs_histogram']}), largest count {int(max_count)}, {z_s * 1e3:.1f} ms first call; "
          "within the ADF allowance of the sweep's")
    for key, n in counts.items():
        launches[key] = launches.get(key, 0) + n

    zero_counters()
    dc = DROPLET
    pos, sid = droplet(2, 2042, device)
    hist, max_count = adf_kernel.adf_histogram(pos, sid, None, dc["cutoff"], dc["n_bins"], 2, k_n=dc["k_n"])
    idx_open = adf_kernel.neighbor_indices(pos, sid, None, dc["cutoff"], dc["k_n"], 2)
    main, main_sid = make_case(ADF["counts"], 4, ADF["box"], 2043, device)
    k_n = AdfPlan(main.shape[1], ADF["box"], ADF["cutoff"]).k_n
    idx_binned = adf_kernel.neighbor_indices(main, main_sid, ADF["box"], ADF["cutoff"], k_n, 2)
    torch.cuda.synchronize()
    counts = mesh_counters()
    plain = adf_histogram_reference(pos, sid, None, dc["cutoff"], dc["n_bins"], 2)
    check_hist("adf_histogram open boundaries vs plain", hist.cpu().numpy(), plain.cpu().numpy())
    for label, ours, args in (("open", idx_open, (pos, sid, None, dc["cutoff"], dc["k_n"], 2)),
                              ("binned", idx_binned, (main, main_sid, ADF["box"], ADF["cutoff"], k_n, 2))):
        if not torch.equal(ours, neighbor_extract_reference(*args, with_idx=True)[6]):
            raise RuntimeError(f"neighbor_indices, {label}: differs from the plain idx")
    expected = {"adf_neighbor_extract open": 2, "adf_neighbor_extract idx": 1, "adf_neighbor_cells idx": 1}
    if any(counts[k] != v for k, v in expected.items()) or counts["plain"]:
        raise RuntimeError(f"adf-wide ops: launches {counts}, expected {expected} and no plain call")
    phase("3 adf-wide", f"adf_histogram(box=None) on 2 frames of the droplet ({sum(dc['counts'])} atoms): "
          f"the sweep with open boundaries, largest count {int(max_count)}, within the ADF allowance of the "
          f"plain ADF; neighbor_indices on the droplet (sweep, open) and on 4 x {main.shape[1]} [3 adf] frames "
          f"(binned) equal to the plain idx; launches { {k: v for k, v in counts.items() if v} }")
    for key, n in counts.items():
        if key != "plain":
            launches[key] = launches.get(key, 0) + n
    return launches


def transport_dump(root, label="3 transport"):
    """The transport dump under ``root``: ``(path, unwrapped walk, dt, MB)``."""
    c = TRANSPORT
    dt = c["timestep"] * c["every"]
    t0 = time.perf_counter()
    wrapped, unwrapped, vel, names = torch_dumps.random_walk(
        c["counts"], c["n_frames"], c["box"], c["sigma"], dt, seed=2026
    )
    path = pathlib.Path(root) / "nacl.lammpstrj"
    torch_dumps.write_dump(path, c["box"], torch_dumps.walk_columns(wrapped, vel, names),
                           every=c["every"], shuffle_seed=2027)
    size_mb = path.stat().st_size / 1e6
    phase(label, f"dump: {sum(c['counts'])} atoms x {c['n_frames']} frames, {size_mb:.1f} "
          f"MB written in {time.perf_counter() - t0:.1f} s")
    return path, unwrapped, dt, size_mb


def ingest_dump(root, path, temperature=None):
    """``(experiment, seconds)``: a Project under ``root`` ingesting ``path``."""
    import lammps_analysis_tpu_torch as lt

    project = lt.Project(name="transport", storage_path=root)
    t0 = time.perf_counter()
    exp = project.add_experiment(
        "t", timestep=TRANSPORT["timestep"], temperature=temperature, units="metal",
        simulation_data=str(path),
    )
    return exp, time.perf_counter() - t0


class Spy:
    """Wrap ``owner.attr`` for the duration of a ``with``: count its calls,
    record the device type of its first tensor argument and add up its wall
    seconds (with ``sync``, after a device synchronise; a generator it returns
    is timed per item, which is the time its consumer waits). Calls may come
    from several threads."""

    def __init__(self, owner, attr, sync=False):
        self.owner, self.attr, self.sync = owner, attr, sync
        self.devices, self.calls, self.seconds = set(), 0, 0.0
        self._lock = threading.Lock()

    def _add(self, seconds):
        with self._lock:
            self.seconds += seconds

    def _timed_items(self, generator):
        while True:
            t0 = time.perf_counter()
            try:
                item = next(generator)
            except StopIteration:
                return
            finally:
                self._add(time.perf_counter() - t0)
            yield item

    def __enter__(self):
        self.original = getattr(self.owner, self.attr)
        self.own = self.attr in vars(self.owner)  # else inherited

        def spy(*args, **kwargs):
            with self._lock:
                self.calls += 1
            for a in list(args) + list(kwargs.values()):
                while isinstance(a, dict) and a:  # a batch, or a batch of batches
                    a = next(iter(a.values()))
                if isinstance(a, torch.Tensor):
                    self.devices.add(a.device.type)
                    break
            t0 = time.perf_counter()
            out = self.original(*args, **kwargs)
            if inspect.isgenerator(out):
                return self._timed_items(out)
            if self.sync:
                torch.cuda.synchronize()
            self._add(time.perf_counter() - t0)
            return out

        setattr(self.owner, self.attr, spy)
        return self

    def __exit__(self, *exc):
        if self.own:
            setattr(self.owner, self.attr, self.original)
        else:
            delattr(self.owner, self.attr)


class Capture:
    """Keep what ``owner.attr`` is called with during a ``with``: each call's
    positional arguments (tensors cloned, as a caller may reuse its buffers)
    and ``note(*args)`` taken at the call."""

    def __init__(self, owner, attr, note=None):
        self.owner, self.attr, self.note, self.calls = owner, attr, note, []

    def __enter__(self):
        self.original = getattr(self.owner, self.attr)
        self.own = self.attr in vars(self.owner)

        def capture(*args, **kwargs):
            kept = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            self.calls.append((kept, self.note(*args) if self.note else None))
            return self.original(*args, **kwargs)

        setattr(self.owner, self.attr, capture)
        return self

    __exit__ = Spy.__exit__


def span_call(label: str, fn, spans: dict) -> None:
    """One call of ``fn`` with each span of ``spans`` (name -> ``Spy``) timed
    (host wall, device work synchronised at the end of each span where the
    spy syncs) and the results DB's calls (lookups, deletes, stores and the
    experiment's attributes); the rest of the call is the calculator's own
    host code."""
    from lammps_analysis_tpu_torch.database.results_db import ResultsDatabase

    db_methods = ("find_computation", "store_computation", "delete_computations",
                  "get_attribute", "set_attribute")
    with contextlib.ExitStack() as stack:
        db = [stack.enter_context(Spy(ResultsDatabase, m)) for m in db_methods]
        for spy in spans.values():
            stack.enter_context(spy)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total = time.perf_counter() - t0
    db_ms = sum(spy.seconds for spy in db) * 1e3
    phase("4 profile", f"{label}, layer spans: {total * 1e3:.3f} ms in all; " + "; ".join(
        f"{name} {spy.seconds * 1e3:.3f} ms in {spy.calls} call(s)" for name, spy in spans.items()
    ) + f"; results DB {db_ms:.3f} ms in {sum(spy.calls for spy in db)} call(s)")


def layer_spans(exp, einstein_with_unwrap, gk) -> None:
    """One forced call of each transport calculator with every layer timed:
    store reads and writes, the unwrap, the wait for the next slab (store
    read, pin and host-to-device copy not hidden behind compute), the MSD
    comb or the ACF, the host fit, the results DB."""
    from lammps_analysis_tpu_torch.calculators import (
        base as calc_base,
        einstein_diffusion_coefficients as einstein_module,
        green_kubo_diffusion_coefficients as gk_module,
    )
    from lammps_analysis_tpu_torch.ops import correlation, msd
    from lammps_analysis_tpu_torch.database.trajectory_store import TrajectoryStore
    from lammps_analysis_tpu_torch.transformations import CoordinateUnwrapper

    for label, fn, device_op, fit in (
        ("Einstein with the unwrap re-run", einstein_with_unwrap,
         (msd, "windowed_msd_sum"), (einstein_module, "fit_einstein_curve")),
        ("GK", gk, (correlation, "windowed_acf_sum"), (gk_module, "cumulative_trapezoid")),
    ):
        span_call(label, fn, {
            "store reads (all threads)": Spy(TrajectoryStore, "load"),
            "store dataset creation": Spy(TrajectoryStore, "ensure_dataset"),
            "store writes": Spy(TrajectoryStore, "append"),
            "unwrap on the device": Spy(CoordinateUnwrapper, "transform_batch", sync=True),
            "waits for the next slab": Spy(calc_base, "prefetch_to_device"),
            f"{device_op[1]} on the device": Spy(*device_op, sync=True),
            f"host {fit[1]}": Spy(*fit),
        })


def transport_main_path(card: str) -> dict:
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.file_io import LAMMPSDumpFile
    from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
    from lammps_analysis_tpu_torch.ops import correlation, msd
    from lammps_analysis_tpu_torch.transformations import CoordinateUnwrapper

    c = TRANSPORT
    n_na, n_cl = c["counts"]
    n_atoms, data_range = n_na + n_cl, c["data_range"]
    config.device = "cuda"
    with tempfile.TemporaryDirectory() as root:
        dump, unwrapped, dt, size_mb = transport_dump(root)
        t0 = time.perf_counter()
        reader = LAMMPSDumpFile(dump)
        n_parsed = sum(chunk.chunk_size for chunk in reader.get_configurations_generator())
        parse_s = time.perf_counter() - t0
        # the temperature serves Nernst-Einstein in [3 distinct]
        exp, ingest_s = ingest_dump(root, dump, temperature=FLUX["temperature"])
        species = {k: v.n_particles for k, v in exp.species.items()}
        if (n_parsed, exp.number_of_configurations) != (c["n_frames"],) * 2 or species != {
            "Na": n_na, "Cl": n_cl
        } or exp.box_array != [c["box"]] * 3 or exp.sample_rate != c["every"]:
            raise RuntimeError(
                f"transport: metadata {exp.number_of_configurations} frames, {species}, box "
                f"{exp.box_array}, sample rate {exp.sample_rate}"
            )
        phase("3 transport", f"parse {size_mb / parse_s:.1f} MB/s ({parse_s:.3f} s, reader alone); "
              f"ingest {ingest_s:.3f} s ({size_mb / ingest_s:.1f} MB/s, parse + npy store); "
              f"{c['n_frames']} frames, Na {n_na} + Cl {n_cl}, box {exp.box_array}, sample rate "
              f"{exp.sample_rate}")

        zero_counters()
        rdf = exp.run.RadialDistributionFunction(
            number_of_configurations=64, cutoff=BENCH["cutoff"], number_of_bins=BENCH["n_bins"],
            plot=False,
        )
        counts = mesh_counters()
        launches, plain = counts["rdf_histogram"], counts["plain"]
        x_angstrom = np.asarray(rdf["Na_Cl"]["x"]) * 10.0
        median = float(np.median(np.asarray(rdf["Na_Cl"]["y"])[(x_angstrom >= 5.0) & (x_angstrom <= 19.9)]))
        if launches < 1 or plain != 0 or abs(median - 1.0) > 0.02:
            raise RuntimeError(f"transport: RDF from the file had {launches} launches, {plain} "
                               f"plain calls, Na_Cl median {median}")
        phase("3 transport", f"RDF from the file, 64 frames: K1 launches {launches}, plain calls 0, "
              f"Na_Cl g(r) median over 5-19.9 A {median:.5f}")

        expected = c["sigma"] ** 2 / (2 * dt) * 1e-8  # A^2/ps -> m^2/s
        kw = dict(data_range=data_range, correlation_time=1, plot=False)
        with Spy(CoordinateUnwrapper, "transform_batch") as unwrap, \
                Spy(msd, "windowed_msd_sum") as comb:
            t0 = time.perf_counter()
            einstein = exp.run.EinsteinDiffusionCoefficients(**kw)
            einstein_s = time.perf_counter() - t0
        worst = 0.0
        for sp, rows in (("Na", slice(0, n_na)), ("Cl", slice(n_na, n_atoms))):
            stored = exp.store.load([f"{sp}/Unwrapped_Positions"])[f"{sp}/Unwrapped_Positions"]
            worst = max(worst, float(np.abs(stored - unwrapped[:, rows]).max()))
        if worst > 1e-3:
            raise RuntimeError(f"transport: unwrapped positions {worst} A from the walk")
        with Spy(correlation, "windowed_acf_sum") as acf:
            t0 = time.perf_counter()
            gk = exp.run.GreenKuboDiffusionCoefficients(**kw)
            gk_s = time.perf_counter() - t0
        if {"cuda"} != unwrap.devices or {"cuda"} != comb.devices or {"cuda"} != acf.devices:
            raise RuntimeError(f"transport: devices unwrap {unwrap.devices}, MSD {comb.devices}, "
                               f"ACF {acf.devices}; all must be cuda")
        phase("3 transport", f"Einstein (auto-unwrap, {unwrap.calls} unwrap slab(s) on "
              f"{unwrap.devices}, {comb.calls} MSD slab(s) on {comb.devices}) {einstein_s:.3f} s; "
              f"unwrapped positions within {worst:.2e} A of the walk; GK ({acf.calls} ACF slab(s) "
              f"on {acf.devices}) {gk_s:.3f} s")
        for sp in ("Na", "Cl"):
            d_e = float(einstein[sp]["diffusion_coefficient"])
            d_gk = float(gk[sp]["diffusion_coefficient"][0])
            bad = abs(d_e / expected - 1) > 0.03 or abs(d_gk / expected - 1) > 0.05 \
                or abs(d_gk / d_e - 1) > 0.05
            phase("3 transport", f"{sp}: D Einstein {d_e:.6e}, GK {d_gk:.6e}, sigma^2/(2 dt) "
                  f"{expected:.6e} m^2/s ({100 * (d_e / expected - 1):+.2f} %, "
                  f"{100 * (d_gk / expected - 1):+.2f} %)")
            if bad:
                raise RuntimeError(f"transport: {sp} D outside 3 % (Einstein) or 5 % (GK)")
        t0 = time.perf_counter()
        arrays = exp.store.load(["Na/Unwrapped_Positions", "Na/Velocities"])
        errors = torch_dumps.assert_series_match_direct(
            einstein.data_dict["Na"], gk.data_dict["Na"], arrays["Na/Unwrapped_Positions"],
            arrays["Na/Velocities"], data_range, 1, exp.units.length, exp.units.time,
        )
        phase("3 transport", f"Na MSD and ACF series ({c['n_frames']} frames x {n_na} atoms, range "
              f"{data_range}) = float64 direct sums on the CPU: MSD largest relative error "
              f"{errors['msd']:.3e} (rtol 1e-5), ACF largest error {errors['acf']:.3e} x acf[0] "
              f"(rtol 1e-5 + 1e-5 x acf[0]); {time.perf_counter() - t0:.1f} s")

        with Spy(msd, "windowed_msd_sum") as comb, \
                Spy(correlation, "windowed_acf_sum") as acf:
            again = (exp.run.EinsteinDiffusionCoefficients(**kw), exp.run.GreenKuboDiffusionCoefficients(**kw))
        if comb.calls or acf.calls or again[0].data_dict != einstein.data_dict \
                or again[1].data_dict != gk.data_dict:
            raise RuntimeError("transport: the second calls were not cache hits")
        phase("3 transport", "second calls: cache hits, no MSD or ACF slab")

        def forced_einstein():
            return exp.run.EinsteinDiffusionCoefficients(force=True, **kw)

        def forced_gk():
            return exp.run.GreenKuboDiffusionCoefficients(force=True, **kw)

        def forced_unwrap():
            for sp in ("Na", "Cl"):
                exp.store.drop(f"{sp}/Unwrapped_Positions")
            return forced_einstein()

        wfa = BatchPlanner.window_plan(c["n_frames"], data_range, 1) * data_range * n_atoms
        walls = {}
        size = f"{c['n_frames']} frames x {n_atoms} atoms, range {data_range}"
        for label, fn in (("Einstein", forced_einstein), ("GK", forced_gk)):
            walls[label] = forced_calls(f"{label} {size}, forced", fn)
            phase("4 profile", f"{label}: {wfa / walls[label] / 1e3:.1f} M window-frame-atoms/s")
        t0 = time.perf_counter()
        forced_unwrap()
        phase("4 profile", f"Einstein forced with the unwrap re-run: "
              f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
        phase("4 profile", f"ingest of the {size_mb:.1f} MB dump: {ingest_s * 1e3:.3f} ms")
        traces = {}
        for label, fn in (("Einstein", forced_einstein), ("GK", forced_gk),
                          ("Einstein with the unwrap re-run", forced_unwrap)):
            traces[label] = profile_call(f"{label} {size}, forced", fn)
        layer_spans(exp, forced_unwrap, forced_gk)
        names_gk = " ".join(traces["GK"]["names"]).lower()
        names_e = " ".join(traces["Einstein"]["names"]).lower()
        if "fft" not in names_gk or "reduce" not in names_gk or "reduce" not in names_e:
            raise RuntimeError("transport: the trace lacks device FFT or reduction kernels")
        phase("3 transport", "device FFT and reduction kernels in the trace")
        fused_einstein(exp, einstein, kw, size, walls, traces)
        distinct_path(exp, dt)

    # the same path from a small dump, on the card and on the CPU
    outputs = {}
    for device in ("cuda", "cpu"):
        config.device = device
        with tempfile.TemporaryDirectory() as root:
            wrapped, _, vel, names = torch_dumps.random_walk(
                [300, 200], 60, c["box"], c["sigma"], c["timestep"] * c["every"], seed=9
            )
            torch_dumps.write_dump(pathlib.Path(root) / "small.lammpstrj", c["box"],
                                   torch_dumps.walk_columns(wrapped, vel, names),
                                   every=c["every"], shuffle_seed=10)
            small, _ = ingest_dump(root, pathlib.Path(root) / "small.lammpstrj")
            arrays = small.store.load([f"{sp}/{p}" for sp in ("Na", "Cl")
                                       for p in ("Positions", "Velocities")])
            kw = dict(data_range=20, plot=False)
            outputs[device] = arrays, (
                small.run.EinsteinDiffusionCoefficients(**kw).data_dict,
                small.run.GreenKuboDiffusionCoefficients(**kw).data_dict,
            )
    config.device = "cuda"
    if any(not np.array_equal(a, outputs["cpu"][0][k]) for k, a in outputs["cuda"][0].items()):
        raise RuntimeError("transport: parsed arrays differ between the card and the CPU runs")
    (e_card, gk_card), (e_cpu, gk_cpu) = outputs["cuda"][1], outputs["cpu"][1]
    torch_dumps.assert_einstein_close(e_card, e_cpu)
    torch_dumps.assert_gk_close(gk_card, gk_cpu)
    phase("3 transport", "small dump (300 + 200 atoms, 60 frames): parsed arrays identical, "
          "Einstein and GK on the card = CPU within the transport tolerance")
    return dict(walls=walls, traces=traces, launches=launches, einstein=einstein, gk=gk)


def fused_einstein(exp, einstein, kw, size, walls, traces) -> None:
    """The fused unwrap stream on the ``[3 transport]`` experiment: with
    ``config.fuse_streaming`` and both ``Unwrapped_Positions`` dropped, a forced
    Einstein call unwraps each slab on the card, writes nothing and gives the
    materialised call's result, every float equal; then its forced-call median
    and trace beside the two materialised ones. The unwrap is stored again
    after it."""
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.transformations import CoordinateUnwrapper

    config.fuse_streaming = True
    try:
        for sp in ("Na", "Cl"):
            exp.store.drop(f"{sp}/Unwrapped_Positions")
        with Spy(CoordinateUnwrapper, "transform_batch") as unwrap, \
                Spy(CoordinateUnwrapper, "run_transformation") as runs:
            t0 = time.perf_counter()
            fused = exp.run.EinsteinDiffusionCoefficients(force=True, **kw)
            fused_s = time.perf_counter() - t0
        left = [sp for sp in ("Na", "Cl") if exp.store.check_existence(f"{sp}/Unwrapped_Positions")]
        if fused.data_dict != einstein.data_dict or left or runs.calls or unwrap.devices != {"cuda"}:
            raise RuntimeError(f"transport: the fused Einstein call differs from the materialised one "
                               f"({fused.data_dict == einstein.data_dict}), stored {left}, ran the "
                               f"transformation {runs.calls} time(s), unwrapped on {unwrap.devices}")
        phase("3 transport", "fused unwrap stream (config.fuse_streaming, Unwrapped_Positions dropped): "
              f"{unwrap.calls} slab unwrap(s) on {unwrap.devices}, no transformation run, nothing "
              f"stored; D Na {float(fused['Na']['diffusion_coefficient'])!r}, Cl "
              f"{float(fused['Cl']['diffusion_coefficient'])!r} == the materialised call's, every float of "
              f"the result equal; {fused_s * 1e3:.3f} ms")

        def forced_fused():
            return exp.run.EinsteinDiffusionCoefficients(force=True, **kw)

        walls["Einstein fused"] = forced_calls(f"Einstein fused unwrap {size}, forced", forced_fused)
        traces["Einstein fused"] = profile_call(f"Einstein fused unwrap {size}, forced", forced_fused)
    finally:
        config.fuse_streaming = False
    exp.run.CoordinateUnwrapper()


def distinct_path(exp, dt) -> None:
    """``[3 distinct]``: both distinct classes on the ``[3 transport]``
    experiment at data_range 200, correlation_time 1, for Na_Na, Na_Cl and
    Cl_Cl: every series held to the float64 bilinear direct sums of the
    stored arrays (``tests/torch_dumps.py``), the Einstein pair to the walk,
    then Nernst-Einstein's ``corrected=True`` with the distinct pair run for
    it; ``[4 profile]`` forced-call medians and traces."""
    from lammps_analysis_tpu_torch.calculators import (
        base as calc_base,
        distinct_diffusion_coefficients as distinct_module,
    )
    from lammps_analysis_tpu_torch.database.trajectory_store import TrajectoryStore
    from lammps_analysis_tpu_torch.ops import correlation, msd

    c = TRANSPORT
    data_range = c["data_range"]
    kw = dict(data_range=data_range, correlation_time=1, plot=False)
    with Spy(msd, "windowed_msd_sum") as comb, Spy(correlation, "windowed_acf_sum") as acf, \
            Spy(correlation, "cross_correlation_biased") as cross:
        t0 = time.perf_counter()
        einstein = exp.run.EinsteinDistinctDiffusionCoefficients(**kw)
        einstein_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        gk = exp.run.GreenKuboDistinctDiffusionCoefficients(**kw)
        gk_s = time.perf_counter() - t0
    if any(spy.devices != {"cuda"} for spy in (comb, acf, cross)):
        raise RuntimeError(f"distinct: self MSD on {comb.devices}, self ACF on {acf.devices}, cross "
                           f"correlation on {cross.devices}; all must be cuda")
    phase("3 distinct", f"Einstein pair {einstein_s * 1e3:.3f} ms ({comb.calls} self MSD slab(s) on "
          f"{comb.devices}), GK pair {gk_s * 1e3:.3f} ms ({acf.calls} self ACF slab(s), {cross.calls} "
          f"cross-correlation batch(es) on {cross.devices}); {c['n_frames']} frames x "
          f"{sum(c['counts'])} atoms, range {data_range}")

    t0 = time.perf_counter()
    u = exp.units
    frame = exp.time_step * exp.sample_rate
    arrays = exp.store.load([f"{sp}/{p}" for sp in ("Na", "Cl")
                             for p in ("Unwrapped_Positions", "Velocities")])
    direct = {}
    for pair in ("Na_Na", "Na_Cl", "Cl_Cl"):
        a, b = pair.split("_")
        msd_d = torch_dumps.distinct_series_direct(
            arrays[f"{a}/Unwrapped_Positions"], arrays[f"{b}/Unwrapped_Positions"], data_range, 1,
            a == b, "msd", u.length)
        vacf_d, d_gk = torch_dumps.distinct_series_direct(
            arrays[f"{a}/Velocities"], arrays[f"{b}/Velocities"], data_range, 1, a == b, "vacf",
            u.length, u.time, frame)
        direct[pair] = dict(msd=msd_d, vacf=vacf_d, d_gk=d_gk)
    errors = {}
    for key, result in (("msd", einstein), ("vacf", gk)):
        scale = max(np.abs(direct[p][key]).max() for p in ("Na_Na", "Cl_Cl"))
        errors[key] = max(np.abs(np.asarray(result[p][key]) - direct[p][key]).max() / scale
                          for p in direct)
        for pair, values in direct.items():
            np.testing.assert_allclose(result[pair][key], values[key], rtol=1e-5, atol=1e-6 * scale,
                                       err_msg=f"distinct {pair} {key}")
    d_scale = max(abs(direct[p]["d_gk"]) for p in ("Na_Na", "Cl_Cl"))
    d_error = max(abs(gk[p]["diffusion_coefficient"] - direct[p]["d_gk"]) for p in direct) / d_scale
    if d_error > 1e-5:
        raise RuntimeError(f"distinct: GK D {d_error:.3e} x the same-species D off the float64 sum")
    phase("3 distinct", f"MSD and VACF series of Na_Na, Na_Cl, Cl_Cl = float64 bilinear direct sums on "
          f"the CPU: largest error {errors['msd']:.3e} (MSD), {errors['vacf']:.3e} (VACF) x the "
          f"same-species series' max (1e-6 + rtol 1e-5 allowed); GK D within {d_error:.3e} x the "
          f"same-species |D|; {time.perf_counter() - t0:.1f} s")

    walk = c["sigma"] ** 2 / (2 * dt) * 1e-8  # A^2/ps -> m^2/s
    d_e = {p: float(einstein[p]["diffusion_coefficient"]) for p in direct}
    d_g = {p: float(gk[p]["diffusion_coefficient"]) for p in direct}
    for pair in ("Na_Na", "Cl_Cl"):
        n = exp.species[pair.split("_")[0]].n_particles
        expected = -(1 - 1 / n) * walk
        phase("3 distinct", f"{pair}: Einstein D {d_e[pair]:.6e} m^2/s, -(1 - 1/N) sigma^2/(2 dt) "
              f"{expected:.6e} ({100 * (d_e[pair] / expected - 1):+.3f} %); GK D {d_g[pair]:.6e}")
        if abs(d_e[pair] / expected - 1) > 0.03:
            raise RuntimeError(f"distinct: {pair} Einstein D off -(1 - 1/N) sigma^2/(2 dt) by more than 3 %")
    phase("3 distinct", f"Na_Cl: Einstein D {d_e['Na_Cl']:.6e} ({100 * abs(d_e['Na_Cl']) / walk:.4f} % of "
          f"sigma^2/(2 dt), 1 % allowed), GK D {d_g['Na_Cl']:.6e} ({100 * abs(d_g['Na_Cl'] / d_g['Na_Na']):.4f} "
          "% of |GK D(Na_Na)|, 2 % allowed)")
    if abs(d_e["Na_Cl"]) > 0.01 * walk or abs(d_g["Na_Cl"]) > 0.02 * abs(d_g["Na_Na"]):
        raise RuntimeError("distinct: the Na_Cl cross term is not near zero")

    exp.set_charge("Na", 1.0)
    exp.set_charge("Cl", -1.0)
    t0 = time.perf_counter()
    ne = exp.run.NernstEinsteinIonicConductivity(corrected=True, plot=False)
    ne_s = time.perf_counter() - t0
    values = ne["System"]
    if ne.args.get("distinct_source") != "EinsteinDistinctDiffusionCoefficients" or not np.isfinite(
            values["corrected_nernst_einstein_ionic_conductivity"]):
        raise RuntimeError(f"distinct: corrected Nernst-Einstein gave {values} with args {ne.args}")
    phase("3 distinct", f"Nernst-Einstein corrected=True (the Einstein self and distinct pairs run for "
          f"it, data_range 100): {values['nernst_einstein_ionic_conductivity']:.6e} S/m, corrected "
          f"{values['corrected_nernst_einstein_ionic_conductivity']:.6e} S/m; {ne_s * 1e3:.3f} ms")

    size = f"{c['n_frames']} frames x {sum(c['counts'])} atoms, range {data_range}"
    for label, name in (("EinsteinDistinct", "EinsteinDistinctDiffusionCoefficients"),
                        ("GreenKuboDistinct", "GreenKuboDistinctDiffusionCoefficients")):
        def forced(name=name):
            return getattr(exp.run, name)(force=True, **kw)

        t0 = time.perf_counter()
        forced()
        phase("3 distinct", f"{label}: one forced call {(time.perf_counter() - t0) * 1e3:.3f} ms")
        forced_calls(f"{label} {size}, forced", forced)
        profile_call(f"{label} {size}, forced", forced)
        spans = {
            "store reads (all threads)": Spy(TrajectoryStore, "load"),
            "waits for the next slab": Spy(calc_base, "prefetch_to_device"),
            "window gathers on the device": Spy(distinct_module._DistinctPair, "_windows", sync=True),
        }
        if label == "EinsteinDistinct":
            spans["self MSD on the device"] = Spy(msd, "windowed_msd_sum", sync=True)
            spans["host fit_einstein_curve"] = Spy(distinct_module, "fit_einstein_curve")
        else:
            spans["self ACF on the device"] = Spy(correlation, "windowed_acf_sum", sync=True)
            spans["cross-correlation FFTs on the device"] = Spy(
                correlation, "cross_correlation_biased", sync=True)
        span_call(f"{label} {size}, forced", forced, spans)


def flux_dump(root, counts, n_frames, seed):
    """``(path, MB)``: a walk of ``counts`` atoms in the transport box with
    seeded forces, per-atom energies and stresses, as a LAMMPS dump."""
    c = FLUX
    wrapped, _, vel, names = torch_dumps.random_walk(
        counts, n_frames, c["box"], c["sigma"], c["timestep"] * c["every"], seed=seed
    )
    cols = torch_dumps.walk_columns(wrapped, vel, names)
    cols.update(torch_dumps.flux_columns(n_frames, sum(counts), seed=seed + 1))
    path = pathlib.Path(root) / "nacl_flux.lammpstrj"
    torch_dumps.write_dump(path, c["box"], cols, every=c["every"], shuffle_seed=seed + 2)
    return path, path.stat().st_size / 1e6


def system_value(result, name: str) -> float:
    """The coefficient of a system calculator's ``data_dict["System"]``."""
    from lammps_analysis_tpu_torch.calculators import ALL_CALCULATORS

    return float(np.ravel(result["System"][ALL_CALCULATORS[name].result_keys[0]])[0])


def system_estimate(exp, name: str, series, data_range: int) -> tuple[float, float]:
    """``(value, prefactor)``: the system calculator's estimator evaluated in
    float64 numpy (``tests/torch_dumps.py``) on a stored (T, 1, 3) series,
    correlation_time 1, with the calculator's own prefactor."""
    from lammps_analysis_tpu_torch.utils.fitting import fit_einstein_curve

    calc = getattr(exp.run, name)
    calc.args = calc.prepare_args(data_range=data_range, correlation_time=1)
    prefactor = calc._prefactor()
    times = np.arange(data_range) * exp.time_step * exp.sample_rate
    scale = SYSTEM[name][1]
    if scale is None:
        msd = prefactor * torch_dumps.msd_system_direct(series, data_range, 1)
        popt, *_ = fit_einstein_curve(times, msd, fit_max_index=data_range - 1)
        return popt[0] / 6.0, prefactor
    _, integral = torch_dumps.gk_system_direct(
        series, data_range, 1, times, data_range if scale == "range" else 1.0
    )
    ir = min(calc.args["integration_range"] - 1, len(integral) - 1)
    return prefactor * integral[ir], prefactor


def flux_main_path(card: str, transport: dict) -> dict:
    """``[3 flux]``: the conductivity path from a per-atom dump on the card."""
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.ops import correlation, msd
    from lammps_analysis_tpu_torch.transformations import CoordinateUnwrapper, flux_transforms
    from lammps_analysis_tpu_torch.utils.units import boltzmann_constant, elementary_charge

    c = FLUX
    n_na, n_cl = c["counts"]
    n_atoms, data_range = n_na + n_cl, c["data_range"]
    dt = c["timestep"] * c["every"]
    calculators = [name for name in SYSTEM if name != "GreenKuboViscosityFlux"]
    kw = dict(data_range=data_range, correlation_time=1, plot=False)
    config.device = "cuda"
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        path, size_mb = flux_dump(root, c["counts"], c["n_frames"], seed=2028)
        write_s = time.perf_counter() - t0
        exp, ingest_s = ingest_dump(root, path, temperature=c["temperature"])
        exp.set_charge("Na", 1.0)
        exp.set_charge("Cl", -1.0)
        props = exp.store.properties_of("Na")
        phase("3 flux", f"dump: {n_atoms} atoms x {c['n_frames']} frames, columns {props}, {size_mb:.1f} "
              f"MB written in {write_s:.1f} s, ingested in {ingest_s:.3f} s ({size_mb / ingest_s:.1f} MB/s); "
              "charges Na +1, Cl -1 from the experiment")

        with contextlib.ExitStack() as stack:
            trafos = {name: stack.enter_context(Spy(getattr(flux_transforms, name), "transform_batch",
                                                     sync=True))
                      for name in FLUX_TRANSFORMATIONS}
            unwrap = stack.enter_context(Spy(CoordinateUnwrapper, "transform_batch"))
            acf = stack.enter_context(Spy(correlation, "windowed_acf_sum"))
            comb = stack.enter_context(Spy(msd, "windowed_msd_sum"))
            t0 = time.perf_counter()
            results = {name: getattr(exp.run, name)(**kw) for name in calculators}
            first_s = time.perf_counter() - t0
        spies = dict(trafos, CoordinateUnwrapper=unwrap, windowed_acf_sum=acf, windowed_msd_sum=comb)
        if any(spy.calls < 1 or spy.devices != {"cuda"} for spy in spies.values()):
            raise RuntimeError("flux: " + ", ".join(
                f"{k} {v.calls} call(s) on {v.devices}" for k, v in spies.items()) + "; all must run on cuda")
        phase("3 flux", f"six system calculators, first calls {first_s:.3f} s with their transformations: "
              + ", ".join(f"{k} {v.calls} slab(s) {v.seconds * 1e3:.1f} ms" for k, v in trafos.items())
              + f"; unwrap {unwrap.calls} slab(s); ACF {acf.calls} and MSD {comb.calls} call(s); every "
              "call on cuda")

        # every series against its formula in float64 on the stored arrays
        names = ("Velocities", "Unwrapped_Positions", "Forces", "Stress", "Kinetic_Energy", "Potential_Energy")
        arrays = {sp: {k: exp.store.load([f"{sp}/{k}"])[f"{sp}/{k}"] for k in names} for sp in ("Na", "Cl")}
        direct = torch_dumps.flux_series_direct(arrays, {"Na": 1.0, "Cl": -1.0}, dt)
        del arrays
        series, errors = {}, {}
        for prop in torch_dumps.FLUX_SERIES:
            series[prop] = exp.store.load([f"Observables/{prop}"])[f"Observables/{prop}"]
            stored, ref = series[prop][:, 0].astype(np.float64), direct[prop]
            errors[prop] = float(np.abs(stored - ref).max() / np.abs(ref).max())
            if series[prop].shape != (c["n_frames"], 1, 3) or not np.allclose(
                stored, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max()
            ):
                raise RuntimeError(f"flux: {prop} {series[prop].shape} off its formula by {errors[prop]:.3e} "
                                   "x max|J|")
        phase("3 flux", "Observables series = float64 formulas on the stored arrays, max|diff| / max|J|: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errors.items()) + " (1e-5 allowed)")

        # every value against its estimator in float64 on those series
        worst = 0.0
        for name in calculators:
            value = system_value(results[name], name)
            estimate, _ = system_estimate(exp, name, series[SYSTEM[name][0]], data_range)
            rel = abs(value / estimate - 1)
            worst = max(worst, rel)
            phase("3 flux", f"{name}: {value:.6e} (float64 estimator {estimate:.6e}, rel. diff {rel:.2e})")
            if rel > 1e-5:
                raise RuntimeError(f"flux: {name} {value} is {rel:.3e} off the float64 estimator {estimate}")

        # Nernst-Einstein over the [3 transport] diffusion coefficients (the
        # same box, counts and charges): e^2/(V kB T) sum_i q_i^2 N_i D_i
        d_walk = TRANSPORT["sigma"] ** 2 / (2 * TRANSPORT["timestep"] * TRANSPORT["every"]) * 1e-8
        analytic = elementary_charge**2 * n_atoms * d_walk / (
            (c["box"] * 1e-10) ** 3 * boltzmann_constant * c["temperature"]
        )
        ne = {}
        for kind, bound in (("einstein", 0.03), ("gk", 0.05)):
            res = exp.run.NernstEinsteinIonicConductivity(diffusion_data=transport[kind], plot=False)
            ne[kind] = res["System"]["nernst_einstein_ionic_conductivity"]
            rel = ne[kind] / analytic - 1
            phase("3 flux", f"Nernst-Einstein over the [3 transport] {kind} D: {ne[kind]:.6e} S/m, analytic "
                  f"{analytic:.6e} S/m ({100 * rel:+.2f} %, {100 * bound:.0f} % allowed)")
            if abs(rel) > bound:
                raise RuntimeError(f"flux: Nernst-Einstein ({kind}) {rel:+.3%} off the analytic value")
        gk_ionic = system_value(results["GreenKuboIonicConductivity"], "GreenKuboIonicConductivity")
        phase("3 flux", f"GK ionic conductivity / Nernst-Einstein (Einstein D): {gk_ionic / ne['einstein']:.4f} "
              f"(no bound: {c['n_frames']} frames do not pin a collective value)")

        with contextlib.ExitStack() as stack:
            spies = [stack.enter_context(Spy(getattr(flux_transforms, name), "transform_batch"))
                     for name in FLUX_TRANSFORMATIONS]
            spies += [stack.enter_context(Spy(correlation, "windowed_acf_sum")),
                      stack.enter_context(Spy(msd, "windowed_msd_sum"))]
            again = {name: getattr(exp.run, name)(**kw) for name in calculators}
        if any(spy.calls for spy in spies) or any(again[k].data_dict != results[k].data_dict for k in again):
            raise RuntimeError("flux: the second calls were not cache hits")
        phase("3 flux", "second calls: cache hits, no transformation, ACF or MSD slab")

        size = f"{c['n_frames']} frames x {n_atoms} atoms, range {data_range}"
        walls, traces = {}, {}
        for name in calculators:
            def forced(name=name):
                return getattr(exp.run, name)(force=True, **kw)

            walls[name] = forced_calls(f"{name} {size}, forced", forced)
            traces[name] = profile_call(f"{name} {size}, forced", forced)
        for name, prop in FLUX_TRANSFORMATIONS.items():
            def rerun(name=name, prop=prop):
                exp.store.drop(f"Observables/{prop}")
                getattr(exp.run, name)()

            walls[name] = forced_calls(f"{name} {size}, re-run", rerun)
            traces[name] = profile_call(f"{name} {size}, re-run", rerun)
        orchestration_energies(exp)

    # the same path from a small dump, on the card and on the CPU
    outputs = {}
    for device in ("cuda", "cpu"):
        config.device = device
        with tempfile.TemporaryDirectory() as root:
            path, _ = flux_dump(root, [300, 200], 20, seed=2033)
            small, _ = ingest_dump(root, path, temperature=c["temperature"])
            small.set_charge("Na", 1.0)
            small.set_charge("Cl", -1.0)
            results = {name: getattr(small.run, name)(data_range=10, plot=False).data_dict["System"]
                       for name in calculators}
            outputs[device] = results, {
                p: small.store.load([f"Observables/{p}"])[f"Observables/{p}"] for p in torch_dumps.FLUX_SERIES
            }
    config.device = "cuda"
    for prop, ref in outputs["cpu"][1].items():
        ref = ref.astype(np.float64)
        if not np.allclose(outputs["cuda"][1][prop], ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max()):
            raise RuntimeError(f"flux: {prop} on the card differs from the CPU's")
    for name, ref in outputs["cpu"][0].items():
        torch_dumps.assert_system_close(outputs["cuda"][0][name], ref)
    phase("3 flux", "small dump (300 + 200 atoms, 20 frames): the six series and six calculators on the "
          "card = CPU within the transport tolerance")
    return dict(walls=walls, traces=traces)


def flux_file_path(card: str) -> dict:
    """``[3 flux-file]``: a 10^6-row LAMMPS flux log -> the GK thermal
    conductivity and the flux-file viscosity on the card."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.file_io import LAMMPSFluxFile
    from lammps_analysis_tpu_torch.ops import correlation

    c = FLUX_FILE
    n, data_range = c["n_rows"], c["data_range"]
    calculators = ("GreenKuboThermalConductivity", "GreenKuboViscosityFlux")
    sigma = {"Thermal_Flux": c["sigma_flux"], "Stress_Visc": c["sigma_pressure"]}
    kw = dict(data_range=data_range, correlation_time=1, plot=False)
    config.device = "cuda"
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        rng = np.random.default_rng(2034)
        flux = rng.normal(scale=c["sigma_flux"], size=(n, 3))
        pressure = rng.normal(scale=c["sigma_pressure"], size=(n, 3))
        path = pathlib.Path(root) / "flux.log"
        torch_dumps.write_flux_file(path, {
            "time": np.arange(n) * c["every"], "temp": c["temperature"] + rng.normal(scale=20.0, size=n),
            **{f"c_flux_thermal[{i + 1}]": flux[:, i] for i in range(3)},
            **{name: pressure[:, i] for i, name in enumerate(("pxy", "pxz", "pyz"))},
        })
        del flux, pressure
        size_mb = path.stat().st_size / 1e6
        write_s = time.perf_counter() - t0

        def reader():
            return LAMMPSFluxFile(path, sample_rate=c["every"], box_l=[c["box"]] * 3)

        t0 = time.perf_counter()
        n_parsed = sum(chunk.chunk_size for chunk in reader().get_configurations_generator())
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exp = lt.Project(name="flux", storage_path=root).add_experiment(
            "log", timestep=c["timestep"], temperature=c["temperature"], units="metal",
            simulation_data=reader(),
        )
        ingest_s = time.perf_counter() - t0
        species = {k: v.n_particles for k, v in exp.species.items()}
        if n_parsed != n or exp.number_of_configurations != n or species != {"Observables": 1}:
            raise RuntimeError(f"flux-file: {n_parsed} rows parsed, {exp.number_of_configurations} "
                               f"configurations, species {species}")
        phase("3 flux-file", f"flux log: {n} rows, {size_mb:.1f} MB written in {write_s:.1f} s; parse "
              f"{size_mb / parse_s:.1f} MB/s ({parse_s:.3f} s, reader alone), ingest {ingest_s:.3f} s "
              f"({size_mb / ingest_s:.1f} MB/s); Observables {exp.store.properties_of('Observables')}")

        results = {}
        with Spy(correlation, "windowed_acf_sum", sync=True) as acf:
            for name in calculators:
                t0 = time.perf_counter()
                results[name] = getattr(exp.run, name)(**kw)
                phase("3 flux-file", f"{name} first call {time.perf_counter() - t0:.3f} s")
        if acf.calls < 2 or acf.devices != {"cuda"}:
            raise RuntimeError(f"flux-file: {acf.calls} ACF call(s) on {acf.devices}")
        dt = c["timestep"] * c["every"]
        for name in calculators:
            prop = SYSTEM[name][0]
            series = exp.store.load([f"Observables/{prop}"])[f"Observables/{prop}"]
            value = system_value(results[name], name)
            t0 = time.perf_counter()
            estimate, prefactor = system_estimate(exp, name, series, data_range)
            # white noise of sd s per axis: only lag 0 of the data_range-scaled
            # ACF survives, 3 s^2 data_range, over half a frame interval
            analytic = prefactor * data_range * 3 * sigma[prop] ** 2 * dt / 2
            rel, off = abs(value / estimate - 1), value / analytic - 1
            phase("3 flux-file", f"{name}: {value:.6e} (float64 estimator {estimate:.6e} in "
                  f"{time.perf_counter() - t0:.1f} s, rel. diff {rel:.2e}; white-noise value "
                  f"{analytic:.6e}, {100 * off:+.2f} %, 8 % allowed)")
            if rel > 1e-5 or abs(off) > 0.08:
                raise RuntimeError(f"flux-file: {name} {value} against estimator {estimate} and white noise "
                                   f"{analytic}")

        walls, traces = {}, {}
        for name in calculators:
            def forced(name=name):
                return getattr(exp.run, name)(force=True, **kw)

            label = f"{name} {n} rows, range {data_range}, forced"
            walls[name] = forced_calls(label, forced)
            traces[name] = profile_call(label, forced)
        phase("4 profile", f"flux log parse {size_mb / parse_s:.1f} MB/s ({n / parse_s / 1e6:.3f} M rows/s, "
              f"reader alone)")
    return dict(walls=walls, traces=traces)


def water_files(root) -> tuple[dict, dict]:
    """The ``[3 water]`` walk and its files under ``root``: ``(walk, {kind:
    (path, MB)})``; a TRR and a DCD of every frame, a ``.gro`` (with
    velocities) and an extxyz of the first ``text_frames``."""
    c = WATER
    t0 = time.perf_counter()
    w = torch_water.water_box(c["n_side"], c["n_frames"], c["box"], c["sigma"], seed=2040)
    gen_s = time.perf_counter() - t0
    dt = c["timestep"] * c["every"]
    v = w["velocities"] / dt
    m = c["text_frames"]
    root = pathlib.Path(root)
    writers = {
        "trr": lambda p: torch_water.write_trr(p, c["box"], x=w["wrapped"], v=v, every=c["every"],
                                               dt_frame=dt),
        "dcd": lambda p: torch_water.write_dcd(p, w["wrapped"], c["box"], every=c["every"]),
        "gro": lambda p: torch_water.write_gro(p, w["wrapped"][:m], c["box"], velocities=v[:m],
                                               dt_frame=dt),
        "extxyz": lambda p: torch_water.write_extxyz(p, w["wrapped"][:m], c["box"], every=c["every"]),
    }
    files, times = {}, {}
    for kind, write in writers.items():
        path = root / f"water.{kind}"
        t0 = time.perf_counter()
        write(path)
        times[kind] = time.perf_counter() - t0
        files[kind] = (path, path.stat().st_size / 1e6)
    phase("3 water", f"{w['n_mol']} rigid waters ({3 * w['n_mol']} atoms, OW HW1 HW2 rows), box "
          f"{c['box']} A, {c['n_frames']} frames, generated in {gen_s:.1f} s; {w['straddling']} "
          "molecules straddle a box face at frame 0; files: " + ", ".join(
              f"{kind} {mb:.1f} MB in {times[kind]:.1f} s" for kind, (_, mb) in files.items()))
    return w, files


def water_readers(root, w, files) -> dict:
    """Each reader alone (MB/s) and through ``add_experiment`` into its own
    experiment, the stored positions against the walk; returns the
    experiments and the parse rates."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.file_io import DCDFile, EXTXYZFile, GROFile, TRRFile

    c = WATER
    n_mol = w["n_mol"]
    rows = torch_water.species_rows(n_mol)
    make = {
        "trr": lambda p: TRRFile(p, species=rows),
        "dcd": lambda p: DCDFile(p, species=rows),
        "gro": lambda p: GROFile(p),
        "extxyz": lambda p: EXTXYZFile(p),
    }
    # float32 rounding; .gro keeps 3 decimals in nm (0.005 A) and the store
    # float32 adds up to 2e-6 A; extxyz 6 decimals, then float32
    tolerance = {"trr": 1e-4, "dcd": 1e-4, "gro": 5.01e-3, "extxyz": 1e-5}
    project = lt.Project(name="water", storage_path=root)
    experiments, rates = {}, {}
    for kind, (path, mb) in files.items():
        t0 = time.perf_counter()
        n_parsed = sum(chunk.chunk_size for chunk in make[kind](path).get_configurations_generator())
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exp = project.add_experiment(kind, timestep=c["timestep"], temperature=300.0, units="metal",
                                     simulation_data=make[kind](path))
        ingest_s = time.perf_counter() - t0
        n_frames = exp.number_of_configurations
        species = {k: v.n_particles for k, v in exp.species.items()}
        if n_parsed != n_frames or species != {"O": n_mol, "H": 2 * n_mol} or \
                not np.allclose(exp.box_array, [c["box"]] * 3, rtol=1e-6):
            raise RuntimeError(f"water {kind}: {n_parsed} frames parsed, {n_frames} stored, species "
                               f"{species}, box {exp.box_array}")
        worst = 0.0
        for sp in ("O", "H"):
            stored = exp.store.load([f"{sp}/Positions"])[f"{sp}/Positions"]
            worst = max(worst, float(np.abs(stored - w["wrapped"][:n_frames, rows[sp]]).max()))
        if worst > tolerance[kind]:
            raise RuntimeError(f"water {kind}: stored positions {worst} A from the walk")
        rates[kind] = mb / parse_s
        experiments[kind] = exp
        phase("3 water", f"{kind}: {n_frames} frames, parse {mb / parse_s:.1f} MB/s ({parse_s:.3f} s, "
              f"reader alone), ingest {mb / ingest_s:.1f} MB/s ({ingest_s:.3f} s); positions within "
              f"{worst:.2e} A of the walk ({tolerance[kind]:g} allowed); species {species}, sample "
              f"rate {exp.sample_rate}")
    return dict(experiments=experiments, rates=rates)


def com_error(com, truth, box) -> np.ndarray:
    """Per molecule, the largest |com - truth| over frames and axes after the
    whole box vector of the first frame (the image of the molecule's first
    atom) is taken off."""
    d = com.astype(np.float64) - truth
    d -= box * np.round(d[:1] / box)
    return np.abs(d).max(axis=(0, 2))


def water_small(device: str) -> dict:
    """The molecular path on 64 waters from a TRR, on ``device``."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.file_io import TRRFile
    from lammps_analysis_tpu_torch.memory.planner import BatchPlanner

    config.device = device
    box = 4 * WATER["box"] / WATER["n_side"]
    w = torch_water.water_box(4, 40, box, WATER["sigma"], seed=2041)
    with tempfile.TemporaryDirectory() as root:
        path = pathlib.Path(root) / "small.trr"
        torch_water.write_trr(path, box, x=w["wrapped"], v=w["velocities"] / 0.02)
        exp = lt.Project(name="small", storage_path=root).add_experiment(
            "w", timestep=WATER["timestep"], units="metal",
            simulation_data=TRRFile(path, species=torch_water.species_rows(64)))
        exp.planner = BatchPlanner(memory_budget_bytes=2**33)
        exp.run.MolecularMap(molecules=[lt.Molecule("water", smiles="[H]O[H]", amount=64, cutoff=1.7)])
        out = dict(
            stored=exp.store.load(["O/Positions", "H/Positions", "water/Unwrapped_Positions"]),
            molecules=exp.molecules,
            d=exp.run.EinsteinDiffusionCoefficients(molecules=True, data_range=20, plot=False).data_dict,
            rdf=exp.run.RadialDistributionFunction(molecules=True, number_of_configurations=10,
                                                   plot=False).data_dict,
            adf=exp.run.AngularDistributionFunction(number_of_configurations=4, cutoff=1.2,
                                                    number_of_bins=200, plot=False).data_dict,
        )
    config.device = "cuda"
    return out


def water_spans(exp, molecule) -> None:
    """One ``MolecularMap`` call with its inputs' unwrap dropped too, each
    layer timed (host wall; device work synchronised at the end of each
    span): the unwrap, the adjacency, the components, the bond-graph check
    (cluster graphs and the matcher), the COM on the device, store reads and
    writes, the results DB."""
    from lammps_analysis_tpu_torch.database.results_db import ResultsDatabase
    from lammps_analysis_tpu_torch.database.trajectory_store import TrajectoryStore
    from lammps_analysis_tpu_torch.transformations import CoordinateUnwrapper, map_molecules

    for path in ("water/Unwrapped_Positions", "water/Positions", "O/Unwrapped_Positions",
                 "H/Unwrapped_Positions"):
        exp.store.drop(path)
    db_methods = ("find_computation", "store_computation", "delete_computations",
                  "get_attribute", "set_attribute")
    with contextlib.ExitStack() as stack:
        spans = {
            "unwrap (both species, with its reads and writes)": Spy(CoordinateUnwrapper, "run_transformation"),
            "adjacency on the device": Spy(map_molecules, "build_adjacency", sync=True),
            "components (scipy)": Spy(map_molecules, "find_molecules"),
            "cluster graphs": Spy(map_molecules, "cluster_graph"),
            "bond-graph matcher": Spy(map_molecules, "is_isomorphic_to_reference"),
            "COM on the device": Spy(map_molecules, "com_batch", sync=True),
            "store reads (all)": Spy(TrajectoryStore, "load"),
            "store writes (all)": Spy(TrajectoryStore, "append"),
        }
        db = [stack.enter_context(Spy(ResultsDatabase, m)) for m in db_methods]
        for spy in spans.values():
            stack.enter_context(spy)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run.MolecularMap(molecules=[molecule])
        total = time.perf_counter() - t0
    db_ms = sum(spy.seconds for spy in db) * 1e3
    phase("4 profile", f"MolecularMap with the unwrap re-run, layer spans: {total * 1e3:.3f} ms in all; "
          + "; ".join(f"{name} {spy.seconds * 1e3:.3f} ms in {spy.calls} call(s)"
                      for name, spy in spans.items())
          + f"; results DB {db_ms:.3f} ms in {sum(spy.calls for spy in db)} call(s)")


def water_rdf_vs_plain(calls) -> dict:
    """K1 on the molecular RDF's own calls (COM frames, species ids, box,
    cutoff, bins), held to the plain version bin for bin; the first call
    timed."""
    from lammps_analysis_tpu_torch.ops import rdf_kernel
    from lammps_analysis_tpu_torch.ops.rdf import rdf_histogram_reference

    for n, (args, _) in enumerate(calls):
        args = tuple(args[:6])
        pos, sid, box, cutoff, n_bins, n_species = args
        ours, plain = rdf_kernel.rdf_histogram(*args), rdf_histogram_reference(*args)
        max_diff = int((ours - plain).abs().max())
        total = int(plain.sum())
        if max_diff != 0 or total == 0:
            raise RuntimeError(f"water K1, call {n}: max |diff| {max_diff} from the plain version, "
                               f"total {total}")
        if n == 0:
            ms = device_ms(lambda: rdf_kernel.rdf_histogram(*args), 10, "rdf_histogram")
            plain_ms = time_ms(lambda: rdf_histogram_reference(*args), 1)
            f, n_atoms, _ = pos.shape
            n_valid = int(((sid >= 0) & (sid < n_species)).sum())
            pairs = f * n_valid * (n_valid - 1) / 2
            # as kernel_vs_plain: ~22 operations a pair, 2 more a kept pair
            bound_ms, bound_by = bound(22 * pairs + 2 * total,
                                       f * n_atoms * 12 + n_atoms * 4 + plain.numel() * 8)
            first = dict(max_diff=0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
            phase("3 water", f"K1 on the molecular RDF's call: {f} x {n_atoms} COMs, cutoff "
                  f"{cutoff:.2f} A, {n_bins} bins, {rdf_kernel.histogram_mode(n_species, n_bins)} "
                  f"histogram, total {total}, equal to the plain version; {ms:.4f} ms on the device, "
                  f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    if not calls:
        raise RuntimeError("water: the molecular RDF made no K1 call")
    phase("3 water", f"K1 equal to the plain version on all {len(calls)} call(s) of the molecular RDF")
    return first


def water_adf_vs_plain(feeds) -> dict:
    """Binned K2 and K3 on the atomistic ADF's own frame batches (the
    runner's species ids, box, cutoff, K and bins, cut into its launch
    chunks): the lists equal the plain extract's, the angle histograms within
    the ADF tolerance of the plain version's on the same lists; the first
    launch timed."""
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import (
        adf_pairs_histogram_reference,
        neighbor_extract_reference,
    )
    from lammps_analysis_tpu_torch.parallel import sharded_ops

    if not feeds:
        raise RuntimeError("water: the atomistic ADF fed no frame batch")
    results, n_launches = {}, 0
    for (runner, positions), k_n in feeds:
        sid, box, cutoff, n_species = runner.species_id, runner.box, runner.cutoff, runner.n_species
        box_t = tuple(float(b) for b in np.asarray(box).reshape(-1))
        route = adf_kernel.extract_route(box_t, cutoff, k_n, positions.shape[1])
        if route != "binned":
            raise RuntimeError(f"water: the ADF's extract routes to {route}, not binned")
        n_frames, n_atoms, _ = positions.shape
        chunk = max(1, sharded_ops.LIST_BYTES // max(n_atoms * k_n * 20, 1))
        for f0 in range(0, n_frames, chunk):
            pos = positions[f0 : f0 + chunk]
            args = (pos, sid, box, cutoff, k_n, n_species)
            ours = adf_kernel.neighbor_extract_binned(*args)
            plain = neighbor_extract_reference(*args)
            counts = plain[5]
            rows = counts <= k_n  # a saturated center: count exact, slots unspecified
            for name, a, b in zip(("rx", "ry", "rz", "d", "sid"), ours, plain):
                if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a[rows], b[rows]):
                    raise RuntimeError(f"water K2 binned: {name} differs from the plain version")
            if not torch.equal(ours[5], counts):
                raise RuntimeError("water K2 binned: counts differ from the plain version")
            del ours
            pair_args = (*plain[:5], counts, sid, runner.n_bins, n_species, runner.norm_power)
            hist = adf_kernel.adf_pairs_histogram(*pair_args)
            hist_plain = adf_pairs_histogram_reference(*pair_args)
            max_diff = check_hist("water K3", hist.cpu().numpy(), hist_plain.cpu().numpy())
            n_launches += 1
            if results:
                results["angles"]["max_diff"] = max(results["angles"]["max_diff"], max_diff)
                continue
            ms = device_ms(lambda: adf_kernel.neighbor_extract_binned(*args), 20, "adf_neighbor_cells")
            plain_ms = time_ms(lambda: neighbor_extract_reference(*args), 1)
            bound_ms, bound_by = extract_bound(pos, sid, box_t, cutoff, n_species, k_n, counts)
            results["extract"] = dict(max_diff=0.0, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
            a_ms = device_ms(lambda: adf_kernel.adf_pairs_histogram(*pair_args), 20, "adf_pairs_histogram")
            a_plain_ms = time_ms(lambda: adf_pairs_histogram_reference(*pair_args), 1)
            angles, (a_bound, a_by) = pairs_bound(plain[4], counts, sid, n_species, hist_plain.numel())
            results["angles"] = dict(max_diff=max_diff, ms=a_ms, plain_ms=a_plain_ms,
                                     bound_ms=a_bound, bound_by=a_by)
            ids, runs = torch.unique_consecutive(sid, return_counts=True)
            layout = ", ".join(f"{i} x {n}" for i, n in zip(ids.tolist(), runs.tolist()))
            phase("3 water", f"binned K2 and K3 on the ADF's launch: {pos.shape[0]} x {n_atoms} atoms "
                  f"(species ids in runs: {layout}), cutoff {cutoff} A, K={k_n}, mean count "
                  f"{float(counts.float().mean()):.3f}, largest {int(counts.max())}; lists equal to the "
                  f"plain version's; K2 {ms:.4f} ms on the device (plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms, {bound_by}); K3 on {angles:.0f} angles, max |diff| {max_diff:.3g}, "
                  f"{a_ms:.4f} ms (plain {a_plain_ms:.3f} ms, bound {a_bound:.4f} ms, {a_by})")
    phase("3 water", f"binned K2 and K3 held to the plain versions on all {n_launches} launch(es) of the ADF")
    return results


def water_main_path(card: str) -> dict:
    """``[3 water]``: MDSuite's water study from GROMACS files on the card."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.calculators import radial_distribution_function
    from lammps_analysis_tpu_torch.graph import molecular_graph
    from lammps_analysis_tpu_torch.ops import msd
    from lammps_analysis_tpu_torch.parallel import sharded_ops
    from lammps_analysis_tpu_torch.transformations import CoordinateUnwrapper, map_molecules

    c = WATER
    config.device = "cuda"
    with tempfile.TemporaryDirectory() as root:
        w, files = water_files(root)
        readers = water_readers(root, w, files)
        exp = readers["experiments"]["trr"]
        n_mol = w["n_mol"]
        box = float(exp.box_array[0])
        water = lt.Molecule("water", smiles="[H]O[H]", amount=n_mol, cutoff=1.7)

        with Spy(CoordinateUnwrapper, "transform_batch") as unwrap, \
                Spy(molecular_graph, "minimum_image") as adjacency, \
                Spy(map_molecules, "com_batch") as com_spy:
            t0 = time.perf_counter()
            exp.run.MolecularMap(molecules=[water])
            map_s = time.perf_counter() - t0
        record = exp.molecules["water"]
        if record["n_particles"] != n_mol or len(record["groups"]) != n_mol:
            raise RuntimeError(f"water: {record['n_particles']} molecules mapped, {n_mol} expected")
        devices = {"unwrap": unwrap.devices, "adjacency": adjacency.devices, "COM": com_spy.devices}
        if any(d != {"cuda"} for d in devices.values()):
            raise RuntimeError(f"water: devices {devices}; all must be cuda")
        com = exp.store.load(["water/Unwrapped_Positions"])["water/Unwrapped_Positions"]
        err = com_error(com, w["com"], box)
        images = np.floor(w["unwrapped"][0] / c["box"]).reshape(n_mol, 3, 3)
        straddles = (images != images[:, :1]).any(axis=(1, 2))
        wrapped = exp.store.load(["water/Positions"])["water/Positions"]
        in_box = bool((wrapped >= 0).all() and (wrapped < np.float32(box)).all())
        if err.max() > 1e-3 or not in_box:
            raise RuntimeError(f"water: COM {err.max()} A from the generator's (straddlers "
                               f"{err[straddles].max()}), wrapped COM in [0, L): {in_box}")
        phase("3 water", f"MolecularMap {map_s:.3f} s: {n_mol} molecules, none rejected; unwrap "
              f"{unwrap.calls} slab(s), adjacency chunks {adjacency.calls // 3}, COM {com_spy.calls} "
              f"slab(s), all on {devices['COM']}; unwrapped COM within {err.max():.2e} A of the "
              f"generator's ({straddles.sum()} straddlers: {err[straddles].max():.2e} A; up to a whole "
              f"box vector), wrapped COM in [0, L)")
        cursor = exp.store.get_cursor("water/Unwrapped_Positions")
        with Spy(map_molecules, "com_batch") as again:
            exp.run.MolecularMap(molecules=[water])
        if again.calls or exp.store.get_cursor("water/Unwrapped_Positions") != cursor:
            raise RuntimeError("water: the second MolecularMap call was not a no-op")
        phase("3 water", "second MolecularMap call: a no-op")

        dt = c["timestep"] * c["every"]
        expected = c["sigma"] ** 2 / (2 * dt) * 1e-8  # A^2/ps -> m^2/s
        kw_e = dict(molecules=True, data_range=c["data_range"], correlation_time=1, plot=False)
        with Spy(msd, "windowed_msd_sum") as comb:
            einstein = exp.run.EinsteinDiffusionCoefficients(**kw_e)
        d = float(einstein["water"]["diffusion_coefficient"])
        if comb.devices != {"cuda"} or abs(d / expected - 1) > 0.03:
            raise RuntimeError(f"water: D {d} against sigma^2/(2 dt) {expected}, MSD on {comb.devices}")
        phase("3 water", f"molecular Einstein (range {c['data_range']}, MSD on {comb.devices}): D "
              f"{d:.6e} m^2/s, sigma^2/(2 dt) {expected:.6e} ({100 * (d / expected - 1):+.2f} %, 3 % "
              "allowed)")

        kw_r = dict(molecules=True, number_of_configurations=64, plot=False)
        zero_counters()
        with Capture(radial_distribution_function, "sharded_rdf_histogram") as rdf_calls:
            rdf = exp.run.RadialDistributionFunction(**kw_r)
        counts = mesh_counters()
        rdf_launches, plain = counts["rdf_histogram"], counts["plain"]
        g = np.asarray(rdf["water_water"]["y"])
        if rdf_launches < 1 or plain != 0 or sorted(rdf.data_dict) != ["water_water"] \
                or not np.all(np.isfinite(g)) or g.sum() <= 0:
            raise RuntimeError(f"water: molecular RDF {rdf_launches} launches, {plain} plain calls, "
                               f"keys {sorted(rdf.data_dict)}")
        x = np.asarray(rdf["water_water"]["x"]) * 10.0
        median = float(np.median(g[x >= x[-1] / 2]))
        phase("3 water", f"molecular RDF water_water, 64 frames x {n_mol} COMs, {g.size} bins: K1 "
              f"launches {rdf_launches}, plain calls 0, g(r) finite, median over "
              f"{x[-1] / 2:.1f}-{x[-1]:.1f} A {median:.4f}")

        zero_counters()
        kw_a = dict(number_of_configurations=16, start=0, cutoff=1.2, number_of_bins=500, plot=False)
        with Capture(sharded_ops.AdfBatchRunner, "feed", note=lambda r, _: r.plan.k_n) as feeds:
            adf = exp.run.AngularDistributionFunction(**kw_a)
        counts = mesh_counters()
        adf_launches = {name: counts[name] for name in ADF_KERNELS}
        plain = counts["plain"]
        peak = adf["O_H_H"]["max_peak"]
        if adf_launches["adf_neighbor_cells"] < 1 or adf_launches["adf_neighbor_extract"] != 0 \
                or adf_launches["adf_pairs_histogram"] < 1 or plain != 0 or abs(peak - 109.47) > 1.0:
            raise RuntimeError(f"water: ADF launches {adf_launches}, {plain} plain calls, O_H_H peak {peak}")
        phase("3 water", f"atomistic ADF, 16 frames x {3 * n_mol} atoms, cutoff 1.2 A, 500 bins: "
              f"launches {adf_launches}, 0 plain calls; O_H_H peak {peak:.3f} deg (109.47 +- 1)")
        # the kernels against their plain versions on the calls the path made
        # (after the launch counts are read: these launches are not counted)
        cases = {"rdf": water_rdf_vs_plain(rdf_calls.calls), **water_adf_vs_plain(feeds.calls)}
        del rdf_calls, feeds

        results = (einstein.data_dict, rdf.data_dict, adf.data_dict)
        before = mesh_counters()
        with Spy(msd, "windowed_msd_sum") as comb:
            again = (exp.run.EinsteinDiffusionCoefficients(**kw_e).data_dict,
                     exp.run.RadialDistributionFunction(**kw_r).data_dict,
                     exp.run.AngularDistributionFunction(**kw_a).data_dict)
        if again != results or mesh_counters() != before or comb.calls:
            raise RuntimeError("water: the second calculator calls were not cache hits")
        phase("3 water", "second calls of Einstein, RDF and ADF: cache hits, no launch, no MSD slab")

        def forced_map():
            exp.store.drop("water/Unwrapped_Positions")
            exp.store.drop("water/Positions")
            exp.run.MolecularMap(molecules=[water])

        forced = {
            "MolecularMap (molecule datasets dropped)": forced_map,
            f"molecular Einstein, range {c['data_range']}": lambda: exp.run.EinsteinDiffusionCoefficients(
                force=True, **kw_e),
            "molecular RDF, 64 frames": lambda: exp.run.RadialDistributionFunction(force=True, **kw_r),
            "atomistic ADF, 16 frames, cutoff 1.2 A": lambda: exp.run.AngularDistributionFunction(
                force=True, **kw_a),
        }
        walls, traces = {}, {}
        for label, fn in forced.items():
            walls[label] = forced_calls(f"water {label}, forced", fn)
            traces[label] = profile_call(f"water {label}, forced", fn)
        if traces["MolecularMap (molecule datasets dropped)"]["device_ms"] <= 0:
            raise RuntimeError("water: no device kernel in the MolecularMap trace")
        water_spans(exp, water)
        phase("4 profile", "water readers' parse rates (reader alone): " + ", ".join(
            f"{kind} {rate:.1f} MB/s" for kind, rate in readers["rates"].items()))

    # the same path on a small water box, on the card and on the CPU
    card, cpu = water_small("cuda"), water_small("cpu")
    for key in ("O/Positions", "H/Positions"):
        if not np.array_equal(card["stored"][key], cpu["stored"][key]):
            raise RuntimeError(f"water small: stored {key} differs between the card and the CPU")
    com_diff = float(np.abs(card["stored"]["water/Unwrapped_Positions"]
                            - cpu["stored"]["water/Unwrapped_Positions"]).max())
    if com_diff > 1e-5 or card["molecules"] != cpu["molecules"] or card["rdf"] != cpu["rdf"]:
        raise RuntimeError(f"water small: COM differs by {com_diff}, or the record or g(r) differs")
    torch_dumps.assert_einstein_close(card["d"], cpu["d"])
    for key, value in cpu["adf"].items():
        if sum(value["adf"]) == 0:
            if sum(card["adf"][key]["adf"]) != 0:
                raise RuntimeError(f"water small: ADF {key} empty on the CPU only")
            continue
        check_hist(f"water small ADF {key}", np.asarray(card["adf"][key]["adf"]), np.asarray(value["adf"]))
    phase("3 water", f"small box (64 waters, 40 frames): stored atoms identical, records equal, COM within "
          f"{com_diff:.1e} A, D within the transport tolerance, g(r) identical, ADF within the angle-"
          "histogram tolerance")
    return dict(rdf_launches=rdf_launches, adf_launches=adf_launches, walls=walls, traces=traces,
                cases=cases)

# [5 mesh]: the calculators the mesh layer shards, by label: (experiment, class, arguments)
def api_path(card: str) -> None:
    """``[3 api]``: the JAX package's last public names on the card. Each op
    runs on CUDA tensors made from a seed and equals the same call on the
    CPU: exactly for the histograms (integer weights) and ``time_cumsum`` on
    integers, within rtol 1e-6 for distances and angles (angles in float64),
    within the transport ACF tolerance (rtol 1e-5 plus 1e-5 x acf[0]) for
    ``acf_biased``. ``PrefetchingLoader.iter_slabs`` yields CUDA tensors equal
    to ``store.load``; ``get_machine_properties`` lists the card with
    ``device_memory_bytes`` as its limit; ``change_memory_fraction`` on the
    CPU's budget gives a plan of more slabs, and leaves the card's budget."""
    from lammps_analysis_tpu_torch.database import (
        PropertyInfo, SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata, TrajectoryStore,
    )
    from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
    from lammps_analysis_tpu_torch.ops import correlation, geometry, histogram
    from lammps_analysis_tpu_torch.pipeline.prefetch import PrefetchingLoader
    from lammps_analysis_tpu_torch.utils import meta
    from lammps_analysis_tpu_torch.utils.config import change_memory_fraction, config

    config.device = "cuda"
    cuda = torch.device("cuda")
    rng = np.random.default_rng(2040)

    def both(fn, *arrays):
        """``fn`` on the arrays as CUDA tensors and as CPU tensors, both on the host."""
        on_card = fn(*(torch.from_numpy(a).to(cuda) for a in arrays))
        if on_card.device.type != "cuda":
            raise RuntimeError(f"api: a result on {on_card.device}, not the card")
        return on_card.cpu().numpy(), fn(*(torch.from_numpy(a) for a in arrays)).numpy()

    def agree(label, ours, cpu, rtol=0.0, atol=0.0):
        if ours.shape != cpu.shape or not np.allclose(ours, cpu, rtol=rtol, atol=atol):
            raise RuntimeError(f"api {label}: the card's result differs from the CPU's "
                               f"(max |diff| {np.abs(ours - cpu).max()})")
        worst = float(np.abs(ours - cpu).max()) if ours.size else 0.0
        phase("3 api", f"{label}: card == CPU, shape {ours.shape}, max |diff| {worst:.3g}")

    box = np.array([40.0, 40.0, 40.0], np.float32)
    a = rng.uniform(0, 40.0, (2048, 3)).astype(np.float32)
    b = rng.uniform(0, 40.0, (1536, 3)).astype(np.float32)
    for label, tbox in (("box", box.tolist()), ("open", None)):
        agree(f"pair_displacements ({label}) 2048 x 1536, float32",
              *both(lambda x, y: geometry.pair_displacements(x, y, tbox), a, b), rtol=1e-6, atol=1e-5)
        agree(f"pair_distances ({label}) 2048 x 1536, float32",
              *both(lambda x, y: geometry.pair_distances(x, y, tbox), a, b), rtol=1e-6)
    v1, v2 = rng.normal(size=(2, 4096, 3))
    agree("angle_between 4096 pairs, float64", *both(geometry.angle_between, v1, v2), rtol=1e-6)
    ints = rng.integers(-1000, 1000, (500, 1024, 3))
    for dim in (0, 1):
        agree(f"time_cumsum dim {dim}, int64 500 x 1024 x 3",
              *both(lambda x: geometry.time_cumsum(x, dim=dim), ints))
    idx = rng.integers(0, 500, (64, 10240)).astype(np.int32)
    weights = rng.integers(0, 3, (64, 10240)).astype(np.float32)
    values = rng.uniform(-1.0, 21.0, (64, 10240))
    for strategy in histogram.STRATEGIES:
        agree(f"masked_histogram strategy {strategy!r}, 655360 entries, 500 bins",
              *both(lambda i, w: histogram.masked_histogram(i, w, 500, strategy), idx, weights))
        agree(f"histogram_fixed_width strategy {strategy!r}, 655360 values, 500 bins",
              *both(lambda v: histogram.histogram_fixed_width(v, 0.0, 20.0, 500, strategy=strategy),
                    values))
    series = rng.normal(size=(4096, 64, 3)).astype(np.float32)
    ours, cpu = both(lambda x: correlation.acf_biased(x, dim=0), series)
    agree("acf_biased 4096 x 64 x 3, float32, dim 0", ours, cpu, rtol=1e-5,
          atol=1e-5 * float(np.abs(cpu[0]).max()))

    with tempfile.TemporaryDirectory() as root:
        store = TrajectoryStore(pathlib.Path(root) / "store")
        prop = PropertyInfo("Positions", 3)
        species = [SpeciesInfo("Na", 5120, [prop]), SpeciesInfo("Cl", 5120, [prop])]
        store.initialize(TrajectoryMetadata(n_configurations=64, species_list=species))
        chunk = TrajectoryChunkData(species, 64)
        for name in ("Na", "Cl"):
            chunk.add_data(rng.uniform(0, 40.0, (64, 5120, 3)).astype(np.float32), 0, name, "Positions")
        store.add_chunk(chunk)
        paths = ["Na/Positions", "Cl/Positions"]
        plan = BatchPlanner(memory_budget_bytes=16 * 10240 * 12).plan(64, 10240 * 12)
        n_slabs = 0
        for (start, stop), slab in zip(plan.slabs(), PrefetchingLoader(store).iter_slabs(paths, plan.slabs())):
            for path in paths:
                if slab[path].device.type != "cuda" or not np.array_equal(
                    slab[path].cpu().numpy(), store.load([path], frames=slice(start, stop))[path]
                ):
                    raise RuntimeError(f"api PrefetchingLoader: slab {start}-{stop} of {path} differs")
            n_slabs += 1
    phase("3 api", f"PrefetchingLoader.iter_slabs: {n_slabs} slabs of {plan.frame_batch} frames x 10240 "
          "atoms (BatchPlan.slabs) as CUDA tensors, each equal to store.load")

    props = meta.get_machine_properties()
    cards = [d for d in props["devices"] if d["platform"] == "cuda"]
    if len(cards) != torch.cuda.device_count() or cards[0]["bytes_limit"] != meta.device_memory_bytes():
        raise RuntimeError(f"api get_machine_properties: {props['devices']} against "
                           f"device_memory_bytes {meta.device_memory_bytes()}")
    phase("3 api", f"get_machine_properties: {props['cpu_count']} CPUs, {props['memory'] / 2**30:.1f} "
          f"GiB, devices {props['devices']}; device_memory_bytes {meta.device_memory_bytes()} on {card}")

    frames, per_frame = 1000, 10240 * 12 * 10
    card_budget = BatchPlanner().budget_bytes
    config.device = "cpu"
    try:
        wide = BatchPlanner().plan(frames, per_frame)
        with change_memory_fraction(1e-5):
            narrow = BatchPlanner().plan(frames, per_frame)
            config.device = "cuda"
            card_under = BatchPlanner().budget_bytes
    finally:
        config.device = "cuda"
    if not narrow.n_batches > wide.n_batches or card_under != card_budget:
        raise RuntimeError(f"api change_memory_fraction: {wide.n_batches} -> {narrow.n_batches} slabs, "
                           f"card budget {card_budget} -> {card_under}")
    phase("3 api", f"change_memory_fraction(1e-5): the CPU plan of {frames} frames x {per_frame} bytes "
          f"goes from {wide.n_batches} to {narrow.n_batches} slabs; the card's budget stays "
          f"{card_budget} bytes (device_memory_fraction)")


# MDSuite's molten NaCl at the main path's size: 2 x 5120 ions at the example's density
NACL_FULL = dict(n_each=5120, n_frames=200, box=17.0 * (5120 / 108) ** (1 / 3))


def examples_path(card: str) -> dict:
    """``[3 examples]``: the port's five examples through their ``main()`` on
    the card, each writing its figures (the HTML of each plot): molten NaCl
    (K1, no plain call), the water study (K1, binned K2 and K3, no sweep and
    no plain call), the flux file, the DCD and the 4-rank world sharing the
    card over gloo (the streamed RDF identical on 1 and 4 ranks, the (2, 2)
    histogram equal to the rank's own). Then molten NaCl once more at
    ``NACL_FULL`` (~150 MB of dump) with its forced RDF and Einstein walls.
    Counts set to 0 just before each example and read just after; the sum is
    the examples' launches."""
    from lammps_analysis_tpu_torch.examples import (
        binary_trajectory_analysis, flux_transport_analysis, molten_nacl_analysis,
        multi_device_scaling, water_molecule_study,
    )

    modules = {
        "molten_nacl_analysis": molten_nacl_analysis,
        "water_molecule_study": water_molecule_study,
        "flux_transport_analysis": flux_transport_analysis,
        "binary_trajectory_analysis": binary_trajectory_analysis,
        "multi_device_scaling": multi_device_scaling,
    }
    needs = {  # kernel records each example must launch, and those it must not
        "molten_nacl_analysis": ({"rdf_histogram"}, set()),
        "water_molecule_study": ({"rdf_histogram", "adf_neighbor_cells", "adf_pairs_histogram"},
                                 {"adf_neighbor_extract"}),
        "binary_trajectory_analysis": ({"rdf_histogram"}, set()),
    }
    total = {name: 0 for name in ("rdf_histogram", "adf_neighbor_cells", "adf_neighbor_extract",
                                  "adf_pairs_histogram")}
    with tempfile.TemporaryDirectory() as root:
        for name, module in modules.items():
            zero_counters()
            t0 = time.perf_counter()
            out = module.main(workdir=pathlib.Path(root) / name, device="cuda")
            seconds = time.perf_counter() - t0
            counts = mesh_counters()
            must, must_not = needs.get(name, (set(), set()))
            if counts["plain"] or any(counts[k] < 1 for k in must) or any(counts[k] for k in must_not):
                raise RuntimeError(f"examples {name}: launches {counts}; must launch {sorted(must)}, "
                                   f"not {sorted(must_not)}, and no plain version")
            figures = sorted(p.name for p in out["figures"].glob("*.html")) if out["figures"].exists() else []
            if name != "multi_device_scaling" and not figures:
                raise RuntimeError(f"examples {name}: no figure written under {out['figures']}")
            if name == "multi_device_scaling" and len(out["ranks"]) != multi_device_scaling.N_RANKS:
                raise RuntimeError(f"examples {name}: {len(out['ranks'])} ranks answered")
            for key in total:
                total[key] += counts[key]
            phase("3 examples", f"{name}.main() on the card in {seconds:.1f} s: launches "
                  f"{ {k: counts[k] for k in total} }, 0 plain calls, figures {figures}")

        zero_counters()
        t0 = time.perf_counter()
        out = molten_nacl_analysis.main(workdir=pathlib.Path(root) / "nacl_full", device="cuda", **NACL_FULL)
        seconds = time.perf_counter() - t0
        counts = mesh_counters()
        if counts["plain"] or counts["rdf_histogram"] < 1:
            raise RuntimeError(f"examples molten NaCl at {NACL_FULL}: launches {counts}")
        for key in total:
            total[key] += counts[key]
        exp = out["experiment"]
        dump_mb = (pathlib.Path(root) / "nacl_full" / "NaCl.lammpstraj").stat().st_size / 1e6
        for key, value in (("D_Na", out["diffusion"]["Na"]["diffusion_coefficient"]),
                           ("sigma", out["sigma"]["System"]["ionic_conductivity"][0])):
            if not np.isfinite(value):
                raise RuntimeError(f"examples molten NaCl at {NACL_FULL}: {key} = {value}")
        g = np.asarray(out["rdf"]["Na_Cl"]["y"])
        if not np.all(np.isfinite(g)) or abs(float(np.median(g[len(g) // 3:])) - 1.0) > 0.05:
            raise RuntimeError(f"examples molten NaCl at {NACL_FULL}: g(r) is not finite or not near 1 far out")
        rdf_kw = dict(number_of_configurations=150, plot=False)
        einstein_kw = dict(data_range=80, correlation_time=10, plot=False)
        size = f"{NACL_FULL['n_frames']} frames x {2 * NACL_FULL['n_each']} atoms"
        rdf_wall = forced_calls(f"molten NaCl example, RDF 150 of {size}, forced",
                                lambda: exp.run.RadialDistributionFunction(force=True, **rdf_kw))
        einstein_wall = forced_calls(f"molten NaCl example, Einstein {size}, forced",
                                     lambda: exp.run.EinsteinDiffusionCoefficients(force=True, **einstein_kw))
        phase("3 examples", f"molten_nacl_analysis.main(n_each={NACL_FULL['n_each']}, n_frames="
              f"{NACL_FULL['n_frames']}, box={NACL_FULL['box']:.2f}) in {seconds:.1f} s ({dump_mb:.1f} MB of dump): launches "
              f"{ {k: counts[k] for k in total} }, 0 plain calls; forced RDF {rdf_wall:.3f} ms, "
              f"forced Einstein {einstein_wall:.3f} ms (medians of 7) on {card}")
    return total


MESH_CALLS = {
    "RDF 64 x 10240": ("rdf", "RadialDistributionFunction", dict(
        number_of_configurations=64, cutoff=BENCH["cutoff"], number_of_bins=BENCH["n_bins"], plot=False)),
    "ADF 16 x 10240": ("adf", "AngularDistributionFunction", dict(
        number_of_configurations=16, start=0, cutoff=ADF["cutoff"], number_of_bins=ADF["n_bins"],
        plot=False)),
    "Einstein 500 x 10240": ("transport", "EinsteinDiffusionCoefficients", dict(
        data_range=TRANSPORT["data_range"], correlation_time=1, plot=False)),
    "GK 500 x 10240": ("transport", "GreenKuboDiffusionCoefficients", dict(
        data_range=TRANSPORT["data_range"], correlation_time=1, plot=False)),
}
MESH_RANKS = 4  # ranks that share the card in [5 mesh] (b)


#: the kernels' records (``mesh_counters``) of the ADF's binned, sweep and angle launches
ADF_KERNELS = ("adf_neighbor_cells", "adf_neighbor_extract", "adf_pairs_histogram")
#: record -> the program's counter (``utils/profiling.py``)
COUNTERS = {
    "rdf_histogram": "k1.launches",
    "adf_neighbor_cells": "k2.launches.binned",
    "adf_neighbor_extract": "k2.launches.sweep",
    "adf_pairs_histogram": "k3.launches",
    "adf_neighbor_extract open": "k2.launches.open",
    "adf_neighbor_extract idx": "k2.launches.idx.sweep",
    "adf_neighbor_cells idx": "k2.launches.idx.binned",
    "adf_neighbor_extract sorted z": "k2.launches.z",
    "adf_neighbor_extract sorted brick": "k2.launches.brick",
    "adf batches": "adf.batches",
    "adf passes": "adf.passes",
    "collectives": "collectives",
}
_COUNTED_FROM = collections.Counter()  # the program's counters at the last zero_counters()


def mesh_counters() -> dict:
    """This process's kernel launches, plain-version calls, ADF batches and
    passes and collectives since ``zero_counters()``, by record."""
    from lammps_analysis_tpu_torch.utils.profiling import counters

    delta = counters - _COUNTED_FROM
    out = {record: delta[name] for record, name in COUNTERS.items()}
    out["plain"] = delta["k1.plain"] + delta["k2.plain"] + delta["k3.plain"]
    return out


def zero_counters() -> None:
    from lammps_analysis_tpu_torch.utils.profiling import counters

    _COUNTED_FROM.clear()
    _COUNTED_FROM.update(counters)


def mesh_run(fn) -> dict:
    """``fn()`` with this process's counters set to 0 just before and read
    just after: ``result``, ``wall`` (seconds, device synchronised),
    ``collectives`` and the ``counts``."""
    zero_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    counts = mesh_counters()
    return dict(result=result, wall=time.perf_counter() - t0, counts=counts,
                collectives=counts["collectives"])


def mesh_world(root: str, two_d: bool) -> dict:
    """One rank of ``[5 mesh]`` (or the process alone, without a group): the
    RDF, ADF, Einstein and GK of ``MESH_CALLS`` over the default mesh
    (first call, cache hit, the median of three forced calls), the DB's rows; with ``two_d``, on a
    (2, ranks / 2) mesh (or (1, ranks)) the RDF calculator through K1's
    rows and the sharded ADF of 16 frames x 10240 atoms through K2's center
    stripes, on the binned route and once with the sweep forced."""
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.parallel import make_2d_mesh, multihost, sharded_adf_histogram, use_mesh

    root = pathlib.Path(root)
    exps = {
        "rdf": ingest(root / "rdf", BENCH["counts"], 100, BENCH["box"][0], seed=2024),
        "adf": ingest(root / "adf", ADF["counts"], 20, ADF["box"][0], seed=2025),
        "transport": ingest_dump(root / "transport", root / "nacl.lammpstrj")[0],
    }
    out = {"calls": {}}
    for label, (key, name, kw) in MESH_CALLS.items():
        run = getattr(exps[key].run, name)
        first = mesh_run(lambda: run(**kw).data_dict)
        again = mesh_run(lambda: run(**kw).data_dict)
        forced = sorted((mesh_run(lambda: run(force=True, **kw).data_dict) for _ in range(3)),
                        key=lambda r: r["wall"])[1]  # the median of three
        out["calls"][label] = dict(
            first=first, hit=again["result"] == first["result"] and again["collectives"] == 0
            and not any(again["counts"].values()), forced={k: v for k, v in forced.items() if k != "result"},
        )
    out["rows"] = {key: [c["name"] for c in exp.db.list_computations(exp.name)] for key, exp in exps.items()}
    if two_d:
        world = multihost.world_size()
        mesh = make_2d_mesh(2, world // 2) if world >= 4 and world % 2 == 0 else make_2d_mesh(1, world)
        key, name, kw = MESH_CALLS["RDF 64 x 10240"]
        with use_mesh(mesh):
            out["rdf 2d"] = mesh_run(lambda: getattr(exps[key].run, name)(force=True, **kw).data_dict)
        pos, sid = make_case(ADF["counts"], 16, ADF["box"], 2030, torch.device(torch.cuda.current_device()))
        route = adf_kernel.extract_route
        for label in ("binned", "sweep"):
            if label == "sweep":
                adf_kernel.extract_route = lambda *args: "sweep"
            try:
                out[f"adf 2d {label}"] = mesh_run(lambda: sharded_adf_histogram(
                    pos, sid, ADF["box"], ADF["cutoff"], ADF["n_bins"], 2, mesh=mesh).cpu().numpy())
            finally:
                adf_kernel.extract_route = route
        out["mesh"] = dict(mesh.shape)
    return out


def mesh_compare(label: str, ours: dict, ref: dict) -> None:
    """Hold a world's results to the process alone's: counts exactly, the ADF
    within its allowance, transport within rtol 1e-5."""
    for call, (_, name, _) in MESH_CALLS.items():
        a, b = ours["calls"][call]["first"]["result"], ref["calls"][call]["first"]["result"]
        if name == "RadialDistributionFunction":
            if a != b:
                raise RuntimeError(f"{label}: the {call} g(r) differs from the process alone's")
        elif name == "AngularDistributionFunction":
            for key in b:
                check_hist(f"{label} {call} {key}", a[key]["adf"], b[key]["adf"])
        elif name == "EinsteinDiffusionCoefficients":
            torch_dumps.assert_einstein_close(a, b)
        else:
            torch_dumps.assert_gk_close(a, b)


def mesh_report(label: str, worlds: list, ref: dict, expect_rows: dict) -> dict:
    """Check every rank of a world: the results, kernels launched and no
    plain call, cache hits, one DB row per computation; print each call's
    walls and collectives beside the process alone's. Returns the launches
    summed over the ranks."""
    launches = {}
    for rank, world in enumerate(worlds):
        mesh_compare(f"{label} rank {rank}", world, ref)
        if world["rows"] != expect_rows:
            raise RuntimeError(f"{label} rank {rank}: DB rows {world['rows']}, expected {expect_rows}")
        for call, r in world["calls"].items():
            counts = r["first"]["counts"]
            if counts["plain"] or not r["hit"]:
                raise RuntimeError(f"{label} rank {rank} {call}: {counts['plain']} plain calls, "
                                   f"cache hit {r['hit']}")
            needed = {"RDF": ("rdf_histogram",), "ADF": ("adf_neighbor_cells", "adf_pairs_histogram")}
            for record in needed.get(call.split()[0], ()):
                if counts[record] < 1:
                    raise RuntimeError(f"{label} rank {rank} {call}: {record} never launched")
            for record, n in counts.items():
                launches[record] = launches.get(record, 0) + n
    for call in MESH_CALLS:
        forced = [w["calls"][call]["forced"] for w in worlds]
        first = [w["calls"][call]["first"] for w in worlds]
        alone = ref["calls"][call]["forced"]["wall"]
        per_rank = {k: [c["counts"][k] for c in first] for k in ("rdf_histogram", "adf_neighbor_cells",
                                                                   "adf_pairs_histogram")}
        phase("5 mesh", f"{label} {call}: equal to the process alone; forced call wall (median of 3) rank 0 "
              f"{forced[0]['wall'] * 1e3:.3f} ms, slowest rank {max(f['wall'] for f in forced) * 1e3:.3f} ms "
              f"(process alone {alone * 1e3:.3f} ms); {forced[0]['collectives']} collectives on rank 0; "
              f"first call {first[0]['wall']:.3f} s; "
              f"launches by rank {per_rank}, 0 plain calls; second call a cache hit on every rank")
    return launches


def mesh_path(card: str) -> dict:
    """``[5 mesh]``: (a) a world of 1 on NCCL, (b) ``MESH_RANKS`` ranks that
    share the card over gloo, (c) one rank per card over NCCL when the
    machine has two or more; each held to the process alone on the same
    inputs. Returns the launches of (b) by kernel record (the 2-D runs' by
    mode record), summed over its ranks."""
    import importlib

    from lammps_analysis_tpu_torch.parallel import multihost, sharded_adf_histogram

    smoke = importlib.import_module("chip_smoke")  # the ranks import the rank body by name
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        transport_dump(tmp, "5 mesh")
        for sub in ("alone", "a", "b", "c"):
            (tmp / sub).mkdir()
            (tmp / sub / "nacl.lammpstrj").symlink_to(tmp / "nacl.lammpstrj")
        t0 = time.perf_counter()
        ref = smoke.mesh_world(str(tmp / "alone"), False)
        pos, sid = make_case(ADF["counts"], 16, ADF["box"], 2030, torch.device("cuda"))
        adf_2d_ref = sharded_adf_histogram(pos, sid, ADF["box"], ADF["cutoff"], ADF["n_bins"], 2).cpu().numpy()
        phase("5 mesh", f"the process alone (no group): {time.perf_counter() - t0:.1f} s")
        rows = {"rdf": ["RadialDistributionFunction"], "adf": ["AngularDistributionFunction"],
                "transport": ["EinsteinDiffusionCoefficients", "GreenKuboDiffusionCoefficients"]}

        t0 = time.perf_counter()
        world_a = multihost.launch_local(1, smoke.mesh_world, str(tmp / "a"), False, backend="nccl",
                                         device="cuda", timeout=400, collective_timeout=300)
        phase("5 mesh", f"(a) a world of 1 rank on cuda:0, backend nccl, through the mesh code: "
              f"{time.perf_counter() - t0:.1f} s with the process start")
        mesh_report("(a) nccl x 1", world_a, ref, rows)

        t0 = time.perf_counter()
        world_b = multihost.launch_local(MESH_RANKS, smoke.mesh_world, str(tmp / "b"), True,
                                         backend="gloo", device="cuda", timeout=600,
                                         collective_timeout=300)
        cards = min(MESH_RANKS, torch.cuda.device_count())
        where = "sharing cuda:0" if cards == 1 else f"on {cards} cards (rank r on cuda:r)"
        phase("5 mesh", f"(b) a world of {MESH_RANKS} ranks {where}, backend gloo (CUDA tensors "
              f"staged through the host for each collective): {time.perf_counter() - t0:.1f} s with "
              "the process starts")
        launches = mesh_report(f"(b) gloo x {MESH_RANKS}", world_b, ref, rows)
        launches.update(mesh_two_d(f"(b) gloo x {MESH_RANKS}", world_b, ref, adf_2d_ref))

        n_cards = torch.cuda.device_count()
        if n_cards >= 2:
            t0 = time.perf_counter()
            world_c = multihost.launch_local(n_cards, smoke.mesh_world, str(tmp / "c"), True,
                                             backend="nccl", device="cuda", timeout=600,
                                             collective_timeout=300)
            phase("5 mesh", f"(c) a world of {n_cards} ranks, one a card, backend nccl: "
                  f"{time.perf_counter() - t0:.1f} s with the process starts")
            mesh_report(f"(c) nccl x {n_cards}", world_c, ref, rows)
            mesh_two_d(f"(c) nccl x {n_cards}", world_c, ref, adf_2d_ref)
        else:
            phase("5 mesh", f"(c) not run: torch.cuda.device_count() is {n_cards} on this machine, and "
                  "NCCL across cards needs two or more")
    return launches


def mesh_two_d(label: str, worlds: list, ref: dict, adf_ref) -> dict:
    """Check the 2-D runs of every rank (K1's rows: the process alone's g(r);
    K2's stripes, binned and swept: its ADF histogram) and print them;
    return their launches summed over the ranks, by mode record."""
    launches = {"rdf_histogram rows": 0, "adf_neighbor_cells stripe": 0,
                "adf_neighbor_extract stripe": 0}
    rdf_ref = ref["calls"]["RDF 64 x 10240"]["first"]["result"]
    for rank, world in enumerate(worlds):
        rdf = world["rdf 2d"]
        if rdf["result"] != rdf_ref or rdf["counts"]["rdf_histogram"] < 1 or rdf["counts"]["plain"]:
            raise RuntimeError(f"{label} rank {rank}: the 2-D RDF differs or skipped K1 ({rdf['counts']})")
        launches["rdf_histogram rows"] += rdf["counts"]["rdf_histogram"]
        for route, record in (("binned", "adf_neighbor_cells"), ("sweep", "adf_neighbor_extract")):
            run = world[f"adf 2d {route}"]
            check_hist(f"{label} rank {rank} 2-D ADF {route}", run["result"], adf_ref)
            other = "adf_neighbor_extract" if route == "binned" else "adf_neighbor_cells"
            if run["counts"][record] < 1 or run["counts"][other] or run["counts"]["plain"] \
                    or run["counts"]["adf_pairs_histogram"] < 1:
                raise RuntimeError(f"{label} rank {rank} 2-D ADF {route}: launches {run['counts']}")
            launches[f"{record} stripe"] += run["counts"][record]
    w = worlds[0]
    phase("5 mesh", f"{label} 2-D mesh {w['mesh']}: the RDF calculator through K1's i-rows equal to the "
          f"process alone (K1 launches by rank {[x['rdf 2d']['counts']['rdf_histogram'] for x in worlds]}, "
          f"forced call wall rank 0 {w['rdf 2d']['wall'] * 1e3:.3f} ms, slowest "
          f"{max(x['rdf 2d']['wall'] for x in worlds) * 1e3:.3f} ms, {w['rdf 2d']['collectives']} "
          f"collectives)")
    for route in ("binned", "sweep"):
        runs = [x[f"adf 2d {route}"] for x in worlds]
        phase("5 mesh", f"{label} 2-D ADF 16 x 10240 through K2's center stripes, {route} route: within "
              f"the ADF allowance of the process alone; extract launches by rank "
              f"{[r['counts'][RECORD_OF_ROUTE[route]] for r in runs]}, angle kernel "
              f"{[r['counts']['adf_pairs_histogram'] for r in runs]}, 0 plain calls; wall rank 0 "
              f"{runs[0]['wall'] * 1e3:.3f} ms, slowest {max(r['wall'] for r in runs) * 1e3:.3f} ms, "
              f"{runs[0]['collectives']} collectives")
    return launches


def kernel_record(name: str, launches: int, cases: list, main: dict, mode: str = "") -> dict:
    return {
        "name": f"{name} {mode}".strip(),
        "route": "cuda",
        "source": CSRC + name + ".cu",
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(c["max_diff"] for c in cases),
        "ms": main["ms"],
        "timing": "cuda_events" if isinstance(main["ms"], EventMs) else "profiler",
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        # no single PyTorch call computes K1-K3; the ACF kernels' torch chain
        "library_ms": main.get("library_ms"),
        **({"floor_ms": main["floor_ms"]} if "floor_ms" in main else {}),
    }


def angle_launch(rounds: int = 3) -> None:
    """The angle kernel's one-frame main-path launch (case a1 of ``[2
    extract]``): device time of its pair kernel, of all its kernels (a
    checkout may round in a second kernel), and CUDA events around
    back-to-back calls of the wrapper, ``rounds`` times."""
    from lammps_analysis_tpu_torch.ops import adf_kernel

    (rx, ry, rz, d, sid_n), counts, sid, n_species = main_path_lists(1, torch.device("cuda"))
    args = (rx, ry, rz, d, sid_n, counts, sid, ADF["n_bins"], n_species, 4)

    def call():
        return adf_kernel.adf_pairs_histogram(*args)

    for _ in range(rounds):
        ms = device_ms(call, 200, "adf_pairs_histogram", parts=("adf_pairs_kernel",))
        every = device_ms(call, 200, "adf_pairs_histogram",
                          parts=("adf_pairs_kernel", "adf_pairs_finish"), present_only=True)
        phase(
            "4 profile",
            f"angle kernel, one-frame launch at K={rx.shape[2]}: pair kernel {ms:.4f} ms on "
            f"the device, all its kernels {every:.4f} ms, {time_ms(call, 200):.4f} ms a "
            "call back to back",
        )


def chunk_sweep() -> None:
    """``--chunks``: the angle kernel's device time at several chunk sizes,
    on the one-frame launch, the mixed frame, K = 1076 and 16 frames."""
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import (
        adf_pairs_histogram_reference,
        neighbor_extract_reference,
    )

    device = torch.device("cuda")
    pos, sid = make_case([1300], 1, (10.0,) * 3, 1340, device)
    *_, counts = neighbor_extract_reference(pos, sid, (10.0,) * 3, 6.0, 1, 1)
    *found, counts = adf_kernel.neighbor_extract(pos, sid, (10.0,) * 3, 6.0, int(counts.max()), 1)
    cases = {
        "a1 one frame": main_path_lists(1, device),
        "mixed widths": mixed_widths_lists(device),
        "K=1076": (found, counts, sid, 1),
        "16 frames": main_path_lists(16, device),
    }
    chosen = adf_kernel.PAIRS_CHUNK
    try:
        for chunk in (256, 512, 1024, 4096):
            adf_kernel.PAIRS_CHUNK = chunk
            for label, ((rx, ry, rz, d, sid_n), counts, sid, n_species) in cases.items():
                args = (rx, ry, rz, d, sid_n, counts, sid, ADF["n_bins"], n_species, 4)
                check_hist(f"chunks {chunk} {label}", adf_kernel.adf_pairs_histogram(*args).cpu().numpy(),
                           adf_pairs_histogram_reference(*args).cpu().numpy())
                ms = device_ms(lambda: adf_kernel.adf_pairs_histogram(*args),
                               3 if label == "K=1076" else 30, "adf_pairs_histogram")
                route = adf_kernel.pairs_histogram_route(n_species, ADF["n_bins"], rx.shape[2],
                                                         rx.shape[1], rx.shape[0])
                phase("2 chunks", f"chunk_pairs {chunk}, {label}: {ms:.4f} ms ({describe_route(route)})")
    finally:
        adf_kernel.PAIRS_CHUNK = chosen


def acf_batches() -> None:
    """``--acf-batches``: ``windowed_acf_sum`` over the ``[3 flux-file]``
    series shape (10^6 x 1 x 3, range 200, stride 1) with 32-window FFT
    batches (``BATCH_BYTES`` = 0) and with the default batches, in turns
    (32, default, default, 32): wall per call after a synchronise, and the
    number of batches."""
    from lammps_analysis_tpu_torch.ops import correlation

    c = FLUX_FILE
    x = torch.randn(c["n_rows"], 1, 3, device="cuda", generator=torch.Generator("cuda").manual_seed(2035))
    budget = int(torch.cuda.mem_get_info()[1] * 0.6)
    default = correlation.BATCH_BYTES
    results = []
    try:
        for batch_bytes in (0, default, default, 0):
            correlation.BATCH_BYTES = batch_bytes
            chunk = correlation._auto_chunk(1, 3, c["data_range"], budget)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s, _ = correlation.windowed_acf_sum(x, c["data_range"], 1, budget)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            results.append(s)
            n_batches = -(-(c["n_rows"] - c["data_range"] + 1) // chunk)
            phase("4 profile", f"windowed_acf_sum 10^6 x 1 x 3, range {c['data_range']}: {chunk} windows a "
                  f"batch ({n_batches} batches), {ms:.3f} ms")
    finally:
        correlation.BATCH_BYTES = default
    scale = float(results[0][0].abs())
    if any(not torch.allclose(r, results[0], rtol=1e-9, atol=1e-9 * scale) for r in results):
        raise RuntimeError("acf batches: the batch size changed the result")


#: GK self-diffusion's full FFT batch (``nacl_gk_32k.gk_diffusion``): 32
#: windows of 500 frames every 5 over one species' 16000 ions x 3, padded
#: to 1024; the slab holds the frames the 32 windows span
GK_BATCH = dict(n_ions=16000, dims=3, window=500, stride=5, windows=32, fft_len=1024)


def mib_steps(steps) -> list:
    """``[(name, MiB)]``: the device memory's peak above what was allocated
    before the first step, read after each ``(name, fn)`` step (the peak is
    not reset between steps); the steps' results are kept alive until the
    end, as a batch keeps them."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kept, out = [], []
    for name, fn in steps:
        kept.append(fn(kept))
        torch.cuda.synchronize()
        out.append((name, (torch.cuda.max_memory_allocated() - base) / 2**20))
    return out


def acf_kernels_vs_plain() -> dict:
    """``[2 acf]``: the windowed ACF's two kernels (``csrc/acf_power.cu``) at
    GK self-diffusion's full batch, against their plain versions on the same
    tensors (the pack bit for bit, with and without the zero tail; the power
    within 1e-12 of every bin and bit for bit from run to run), cuFFT's R2C
    leaving the packed buffer as it was, each kernel's device time, its
    bound (bytes over the memory rate), the plain version's time and the
    torch chain's it replaces (``library_ms``: the pad and strided copy that
    ``rfft`` ran on the windows' view, timed as ``rfft`` of the view less
    ``rfft`` of the packed buffer; the square, float64 cast and float64
    sum); then the peak device memory after each step of one batch, torch
    chain and kernels."""
    from lammps_analysis_tpu_torch.ops import correlation as C

    c = GK_BATCH
    w, stride, n, fft_len = c["window"], c["stride"], c["windows"], c["fft_len"]
    frames = (n - 1) * stride + w
    n_seq = c["n_ions"] * c["dims"]
    n_freq = fft_len // 2 + 1
    x = torch.randn((frames, c["n_ions"], c["dims"]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2025))
    seg = x.unfold(0, w, stride)[:n]
    results = {}

    buf = C.acf_pack(x, w, stride, 0, n, fft_len)
    plain = C.acf_pack_reference(x, w, stride, 0, n, fft_len)
    tail_equal = torch.equal(buf, plain)
    buf[..., :w].zero_()
    C.acf_pack(x, w, stride, 0, n, fft_len, out=buf)
    reuse_equal = torch.equal(buf, plain)
    spec = torch.fft.rfft(buf, n=fft_len, dim=-1)
    torch.cuda.synchronize()
    r2c_kept = torch.equal(buf, plain)
    if not (tail_equal and reuse_equal and r2c_kept):
        raise RuntimeError(f"acf_pack: equal to plain {tail_equal} (tail), {reuse_equal} "
                           f"(reused buffer), buffer kept by the R2C {r2c_kept}")
    del plain
    pack_ms = device_ms(lambda: C.acf_pack(x, w, stride, 0, n, fft_len, out=buf), 10, "acf_pack")
    tail_ms = device_ms(lambda: C.acf_pack(x, w, stride, 0, n, fft_len), 5, "acf_pack")
    plain_ms = time_ms(lambda: C.acf_pack_reference(x, w, stride, 0, n, fft_len), 3)
    fft_ms = time_ms(lambda: torch.fft.rfft(buf, n=fft_len, dim=-1), 5)
    pad_ms = time_ms(lambda: torch.fft.rfft(seg, n=fft_len, dim=-1), 3) - fft_ms
    pack_bytes = n * n_seq * w * 4 + frames * n_seq * 4
    bound_ms, bound_by = bound(0.0, pack_bytes)
    tail_bound = bound(0.0, n * n_seq * fft_len * 4 + frames * n_seq * 4)[0]
    phase("2 acf", f"acf_pack {n} x {n_seq} x {w} -> {fft_len}: equal to plain (tail, reused buffer), "
          f"the R2C keeps its input; kernel {pack_ms:.3f} ms into the reused buffer ({pack_bytes / pack_ms / 1e6:.0f}"
          f" GB/s), {tail_ms:.3f} ms with the tail (bound {tail_bound:.3f}), plain {plain_ms:.3f} ms, "
          f"the pad inside rfft {pad_ms:.3f} ms, cuFFT R2C {fft_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({bound_by}; {100 * bound_ms / pack_ms:.1f} % of it)")
    results["acf_pack"] = dict(max_diff=0.0, ms=pack_ms, plain_ms=plain_ms, library_ms=pad_ms,
                               bound_ms=bound_ms, bound_by=bound_by, tail_ms=tail_ms, fft_ms=fft_ms)

    power = C.acf_power_sum(spec)
    again = C.acf_power_sum(spec)
    plain = C.acf_power_sum_reference(spec.clone())
    rel = float(((power - plain).abs() / plain.abs()).max())
    if rel > 1e-12 or not torch.equal(power, again):
        raise RuntimeError(f"acf_power_sum: {rel:.3e} from plain, repeats {torch.equal(power, again)}")
    del plain
    chunks, rows = C.power_split(n, n_seq, n_freq, torch.cuda.get_device_properties(0).multi_processor_count)
    power_ms = device_ms(lambda: C.acf_power_sum(spec), 10, "acf_power_sum")
    plain_ms = time_ms(lambda: C.acf_power_sum_reference(spec), 3)  # squares spec again each call
    chain_ms = time_ms(lambda: torch.sum(torch.view_as_real(spec).view(n, c["n_ions"], c["dims"], n_freq, 2)
                                         .square_(), dim=(1, 2, 4), dtype=torch.float64), 3)
    power_bytes = n * n_seq * n_freq * 8 + n * chunks * n_freq * 16 + n * n_freq * 8
    bound_ms, bound_by = bound(0.0, power_bytes)
    phase("2 acf", f"acf_power_sum {n} x {n_seq} x {n_freq}: {chunks} chunks of {rows} sequences a window, "
          f"{rel:.2e} from plain at most, bit for bit run to run; kernel {power_ms:.3f} ms "
          f"({power_bytes / power_ms / 1e6:.0f} GB/s), plain {plain_ms:.3f} ms, the torch chain "
          f"(square_, float64 sum) {chain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; "
          f"{100 * bound_ms / power_ms:.1f} % of it)")
    results["acf_power_sum"] = dict(max_diff=rel, ms=power_ms, plain_ms=plain_ms, library_ms=chain_ms,
                                    bound_ms=bound_ms, bound_by=bound_by)
    del spec, buf, power, again
    torch.cuda.empty_cache()

    chain = mib_steps([
        ("rfft of the windows' view (pad, copy, R2C)", lambda k: torch.fft.rfft(seg, n=fft_len, dim=-1)),
        ("square_", lambda k: torch.view_as_real(k[0]).square_()),
        ("float64 sum", lambda k: torch.sum(k[1], dim=(1, 2, 4), dtype=torch.float64)),
    ])
    torch.cuda.empty_cache()
    kernels = mib_steps([
        ("acf_pack (buffer)", lambda k: C.acf_pack(x, w, stride, 0, n, fft_len)),
        ("rfft of the buffer (R2C)", lambda k: torch.fft.rfft(k[0], n=fft_len, dim=-1)),
        ("acf_power_sum", lambda k: C.acf_power_sum(k[1])),
    ])
    torch.cuda.empty_cache()
    for label, steps in (("torch chain", chain), ("kernels", kernels)):
        phase("2 acf", f"one batch's peak above the slab, {label}: "
              + "; ".join(f"after {name} {mib:.1f} MiB" for name, mib in steps))
    results["peak_steps"] = dict(chain=chain, kernels=kernels)
    del x, seg
    torch.cuda.empty_cache()
    results["slab"] = acf_slab_calls()
    return results


def torch_chain_acf_sum(x, window, stride, budget_bytes):
    """``windowed_acf_sum`` as torch ops alone, the loop the two kernels
    replaced (strided view, ``rfft`` with its own padding, ``square_``,
    float64 ``sum``): the yardstick of ``acf_slab_calls``."""
    from lammps_analysis_tpu_torch.ops import correlation as C

    n_windows = (x.shape[0] - window) // stride + 1
    chunk = C._auto_chunk(x.shape[1], x.shape[2], window, budget_bytes)
    fft_len = C._next_fast_len(2 * window)
    windows = x.unfold(0, window, stride)
    acf_sum = torch.zeros(window, dtype=torch.float64, device=x.device)
    for c0 in range(0, n_windows, chunk):
        f = torch.view_as_real(torch.fft.rfft(windows[c0 : c0 + chunk], n=fft_len, dim=-1))
        power = torch.sum(f.square_(), dim=(1, 2, 4), dtype=torch.float64)
        acf_sum += (torch.fft.irfft(power, n=fft_len, dim=-1)[:, :window] / window).sum(0)
    return acf_sum


def acf_slab_calls() -> dict:
    """``[2 acf]``: one GK self-diffusion slab (1000 frames of 16000 ions x 3,
    101 windows in 4 batches) through ``windowed_acf_sum`` and through the
    torch chain it replaced, in turns (chain, kernels, kernels, chain): wall
    of each after a synchronise, and the peak device memory above the slab
    (what sets GK D's ``peak_device_MiB``); the sums agree within 1e-6 of
    the lag-0 value."""
    from lammps_analysis_tpu_torch.ops import correlation as C

    c = GK_BATCH
    x = torch.randn((1000, c["n_ions"], c["dims"]), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(2026))
    budget = int(0.6 * torch.cuda.mem_get_info()[1])
    runs = {"chain": lambda: torch_chain_acf_sum(x, c["window"], c["stride"], budget),
            "kernels": lambda: C.windowed_acf_sum(x, c["window"], c["stride"], budget)[0]}
    out = {name: dict(ms=[], peak_mib=[]) for name in runs}
    sums = {}
    for name in ("chain", "kernels", "kernels", "chain"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sums[name] = runs[name]()
        torch.cuda.synchronize()
        out[name]["ms"].append((time.perf_counter() - t0) * 1e3)
        out[name]["peak_mib"].append((torch.cuda.max_memory_allocated() - base) / 2**20)
    gap = float((sums["kernels"] - sums["chain"]).abs().max() / sums["chain"][0])
    if gap > 1e-6:
        raise RuntimeError(f"windowed_acf_sum: {gap:.3e} of acf[0] from the torch chain")
    for name, rec in out.items():
        phase("2 acf", f"one GK D slab (1000 x {c['n_ions']} x {c['dims']}, 101 windows, 4 batches), {name}: "
              f"{', '.join(f'{ms:.2f}' for ms in rec['ms'])} ms, peak above the slab "
              f"{', '.join(f'{mib:.1f}' for mib in rec['peak_mib'])} MiB")
    phase("2 acf", f"the sums agree within {gap:.2e} of acf[0]")
    return out


def k1_ab(rounds: int = 3) -> None:
    """``--k1``: K1 alone at the main path's shape (64 x 10240, 2 species x
    500 bins) and at the LJ shape (32 x 32000, 1 species x 5709 bins), each
    held once to the plain version bin for bin, then its device time
    (``device_ms``, 5 launches) in ``rounds`` rounds, for an A/B of two
    checkouts' K1 on one card (copy this script into the other checkout and
    run it there too: a wrapper without ``histogram_layout`` names its
    ``histogram_mode`` alone)."""
    from lammps_analysis_tpu_torch.ops import rdf_kernel
    from lammps_analysis_tpu_torch.ops.rdf import rdf_histogram_reference

    device = torch.device("cuda")
    shapes = {"main path 64x10240": dict(BENCH, n_frames=64), "LJ 32x32000": dict(LJ, n_frames=32)}
    for seed, (label, c) in enumerate(shapes.items()):
        pos, sid = make_case(c["counts"], c["n_frames"], c["box"], seed, device)
        n_species = len(c["counts"])
        args = (pos, sid, c["box"], c["cutoff"], c["n_bins"], n_species)
        if hasattr(rdf_kernel, "histogram_layout"):
            layout = rdf_kernel.histogram_layout(n_species, c["n_bins"])
            where = f"{layout.mode}, {layout.blocks_per_sm} blocks an SM"
        else:
            where = rdf_kernel.histogram_mode(n_species, c["n_bins"])
        if not torch.equal(rdf_kernel.rdf_histogram(*args), rdf_histogram_reference(*args)):
            raise RuntimeError(f"K1 {label}: the kernel disagrees with the plain version")
        n_valid = sum(c["counts"])
        pairs = c["n_frames"] * n_valid * (n_valid - 1) / 2
        times = [device_ms(lambda: rdf_kernel.rdf_histogram(*args), 5, "rdf_histogram")
                 for _ in range(rounds)]
        phase("2 k1", f"{label} ({where}), equal to the plain version: "
              f"{', '.join(f'{ms:.4f}' for ms in times)} ms a launch, "
              f"{pairs / min(times) / 1e6:.2f} Gpairs/s at the best")
        del pos, sid
        torch.cuda.empty_cache()


def walls() -> None:
    """``--walls``: only the forced-call medians of the main paths (RDF, ADF,
    Einstein, Green-Kubo) and the angle kernel's one-frame launch, for an A/B of two checkouts on one card
    (copy this script into the other checkout and run it there too)."""
    from lammps_analysis_tpu_torch import config

    config.device = "cuda"
    with tempfile.TemporaryDirectory() as root:
        exp = ingest(root, BENCH["counts"], 100, BENCH["box"][0], seed=2024)
        kw = dict(number_of_configurations=64, cutoff=BENCH["cutoff"],
                  number_of_bins=BENCH["n_bins"], plot=False)
        exp.run.RadialDistributionFunction(**kw)
        forced_calls("RDF 64 frames x 10240 atoms, forced",
                     lambda: exp.run.RadialDistributionFunction(force=True, **kw))
    with tempfile.TemporaryDirectory() as root:
        exp = ingest(root, ADF["counts"], 20, ADF["box"][0], seed=2025)
        kw = dict(number_of_configurations=16, start=0, cutoff=ADF["cutoff"],
                  number_of_bins=ADF["n_bins"], plot=False)
        exp.run.AngularDistributionFunction(**kw)
        forced_calls("ADF 16 frames x 10240 atoms, forced",
                     lambda: exp.run.AngularDistributionFunction(force=True, **kw), n=15)
    with tempfile.TemporaryDirectory() as root:
        exp, _ = ingest_dump(root, transport_dump(root)[0])
        kw = dict(data_range=TRANSPORT["data_range"], correlation_time=1, plot=False)
        for name in ("EinsteinDiffusionCoefficients", "GreenKuboDiffusionCoefficients"):
            getattr(exp.run, name)(**kw)  # the first Einstein call materialises the unwrap
            forced_calls(f"{name} {TRANSPORT['n_frames']} frames x {sum(TRANSPORT['counts'])} "
                         f"atoms, range {TRANSPORT['data_range']}, forced",
                         lambda name=name: getattr(exp.run, name)(force=True, **kw))
    angle_launch()


def main() -> int:
    if sys.argv[1:] == ["--walls"]:
        environment()
        walls()
        return 0
    if sys.argv[1:] == ["--k1"]:
        environment()
        build()
        k1_ab()
        return 0
    if sys.argv[1:] == ["--chunks"]:
        environment()
        chunk_sweep()
        return 0
    if sys.argv[1:] == ["--acf-batches"]:
        environment()
        acf_batches()
        return 0
    if sys.argv[1:] == ["--acf"]:
        environment()
        build()
        acf_kernels_vs_plain()
        return 0
    if sys.argv[1:] == ["--extract"]:
        card = environment()
        build()
        adf_kernels_vs_plain(angles=False)
        extract_stripes()
        extract_modes()
        adf_wide_path(card)
        return 0
    card = environment()
    build()
    rdf = kernel_vs_plain()
    rows = kernel_rows()
    adf = adf_kernels_vs_plain()
    stripes = extract_stripes()
    modes = extract_modes()
    acf = acf_kernels_vs_plain()
    from lammps_analysis_tpu_torch.utils.profiling import counters

    acf_before = counters.copy()
    rdf_launches, _ = main_path(card)
    adf_launches, _ = adf_main_path(card)
    wide = adf_wide_path(card)
    for name in adf_launches:
        adf_launches[name] += wide[name]
    transport = transport_main_path(card)
    flux_main_path(card, transport)
    flux_file_path(card)
    water = water_main_path(card)
    rdf_launches += water["rdf_launches"]
    for name, n in water["adf_launches"].items():
        adf_launches[name] += n
    rdf["w water molecular RDF"] = water["cases"]["rdf"]
    adf["extract binned w water ADF"] = water["cases"]["extract"]
    adf["angles w water ADF"] = water["cases"]["angles"]
    api_path(card)
    examples = examples_path(card)
    rdf_launches += examples["rdf_histogram"]
    for name in adf_launches:
        adf_launches[name] += examples[name]
    mesh = mesh_path(card)
    rdf_launches += mesh["rdf_histogram"]
    for name in adf_launches:
        adf_launches[name] += mesh[name]
    from lammps_analysis_tpu_torch import Report

    phase("3 orchestration", "Report: " + "; ".join(f"{k} {v}" for k, v in sorted(Report().info.items())))

    def cases(prefix):
        return [v for k, v in adf.items() if k.startswith(prefix)]

    one_frame = "a1 main-path launch 1x10240"
    records = [
        kernel_record("rdf_histogram", rdf_launches, list(rdf.values()),
                      rdf["m main path 64x10240"]),
        kernel_record("adf_neighbor_cells", adf_launches["adf_neighbor_cells"],
                      cases("extract binned"), adf[f"extract binned {one_frame}"]),
        kernel_record("adf_neighbor_extract", adf_launches["adf_neighbor_extract"],
                      cases("extract sweep"), adf[f"extract sweep {one_frame}"]),
        kernel_record("adf_pairs_histogram", adf_launches["adf_pairs_histogram"],
                      cases("angles"), adf["angles a1 main-path launch, 1 frame"]),
        kernel_record("rdf_histogram", mesh["rdf_histogram rows"], [rows], rows, "rows"),
        kernel_record("adf_neighbor_cells", mesh["adf_neighbor_cells stripe"], [stripes["binned"]],
                      stripes["binned"], "stripe"),
        kernel_record("adf_neighbor_extract", mesh["adf_neighbor_extract stripe"], [stripes["sweep"]],
                      stripes["sweep"], "stripe"),
        *(kernel_record(record.split()[0], wide[record], [modes[record]], modes[record],
                        record.split(" ", 1)[1])
          for record in ("adf_neighbor_extract idx", "adf_neighbor_cells idx", "adf_neighbor_extract open",
                         "adf_neighbor_extract sorted z", "adf_neighbor_extract sorted brick")),
        *(kernel_record(name, counters[counter] - acf_before[counter], [acf[name]], acf[name])
          for name, counter in (("acf_pack", "acf.pack.launches"), ("acf_power_sum", "acf.power.launches"))),
    ]
    idle = [r["name"] for r in records if r["launches"] < 1]
    if idle:
        raise RuntimeError(f"no launch on the main paths of {idle}")
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
