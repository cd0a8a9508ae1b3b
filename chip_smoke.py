#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lammps_analysis_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is not 0):

0. environment: torch and CUDA versions, the card's name, compute capability
   and power limit, and which optional packages import (for the record: the
   port's main path needs none of them);
1. build: nvcc compiles ``lammps_analysis_tpu_torch/csrc/*.cu`` for sm_90a;
2. kernel vs plain: the CUDA pair-histogram kernel and its plain torch
   version on the same seeded inputs on the card, equal bin for bin, with
   both times (CUDA events, after a warm-up call);
3. main path: a ``Project`` with a 10240-atom Na/Cl experiment ingested in
   memory, ``exp.run.RadialDistributionFunction`` over 64 frames with 500
   bins, checked to go through the kernel and never the plain version, to
   give an ideal-gas g(r), and to be a cache hit when run again; then the
   same path on a small input, on the card and on the CPU, giving the same
   g(r).

The second-to-last line is a JSON summary of the kernels, the last line the
device record ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero before printing either.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_SOURCE = "lammps_analysis_tpu_torch/csrc/rdf_histogram.cu"
KERNEL_REPLACES = "lammps_analysis_tpu/ops/pallas_rdf.py:85"

# the bench workload of the JAX package: Na + Cl, box 40 A, cutoff 19.9 A
BENCH = dict(counts=[5120, 5120], box=(40.0, 40.0, 40.0), cutoff=19.9, n_bins=500)


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
        f"CUDA {torch.version.cuda}, {name}, compute capability {cap}",
    )
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is {cap}")
    optional = {
        mod: importlib.util.find_spec(mod) is not None
        for mod in ("h5py", "pandas", "psutil", "matplotlib")
    }
    phase("0 env", f"optional packages present (not needed): {optional}")
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


def make_case(counts, n_frames, box, seed, device):
    """Seeded positions (F, Npad, 3) float32 and ids (Npad,) int32, on ``device``."""
    from lammps_analysis_tpu_torch.ops.rdf import build_species_layout

    sid, n_pad, _, _, _ = build_species_layout(counts, pad_to=8)
    rng = np.random.default_rng(seed)
    n_total = sum(counts)
    pos = np.zeros((n_frames, n_pad, 3), np.float32)
    pos[:, :n_total] = rng.uniform(0.0, 1.0, (n_frames, n_total, 3)) * np.asarray(box)
    return torch.from_numpy(pos).to(device), torch.from_numpy(sid).to(device)


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


def kernel_vs_plain() -> dict:
    from lammps_analysis_tpu_torch.ops import rdf_kernel
    from lammps_analysis_tpu_torch.ops.rdf import rdf_histogram_reference

    cases = {
        "a bench 4x10240": dict(BENCH, n_frames=4, shared=True, reps=(20, 3)),
        "b ragged 3 species N=1000": dict(
            counts=[400, 350, 245], box=(30.0, 33.0, 36.0), cutoff=9.9, n_bins=75,
            n_frames=3, shared=True, reps=(20, 3),
        ),
        "c global atomics 4 species x 6000 bins": dict(
            counts=[500, 500, 500, 500], box=(30.0, 30.0, 30.0), cutoff=14.9,
            n_bins=6000, n_frames=2, shared=False, reps=(10, 3),
        ),
        "m main path 64x10240": dict(BENCH, n_frames=64, shared=True, reps=(5, 2)),
    }
    device = torch.device("cuda")
    results = {}
    for seed, (label, c) in enumerate(cases.items()):
        pos, sid = make_case(c["counts"], c["n_frames"], c["box"], seed, device)
        args = (pos, sid, c["box"], c["cutoff"], c["n_bins"], len(c["counts"]))
        shared = rdf_kernel.uses_shared_histogram(len(c["counts"]), c["n_bins"])
        if shared != c["shared"]:
            raise RuntimeError(f"case {label}: expected shared={c['shared']}, got {shared}")
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
        ms = time_ms(lambda: rdf_kernel.rdf_histogram(*args), c["reps"][0])
        plain_ms = time_ms(lambda: rdf_histogram_reference(*args), c["reps"][1])
        n = sum(c["counts"])
        pairs = c["n_frames"] * n * (n - 1) / 2
        phase(
            "2 kernel",
            f"{label}: {'shared' if shared else 'global'} histogram, total "
            f"{total}, max |diff| {max_diff}, kernel {ms:.3f} ms "
            f"({pairs / ms / 1e6:.2f} Gpairs/s), plain {plain_ms:.3f} ms",
        )
        results[label] = dict(max_diff=max_diff, ms=ms, plain_ms=plain_ms)
        del pos, sid, h_kernel, h_plain
        torch.cuda.empty_cache()
    return results


def ingest(root, counts, n_frames, box, seed):
    """A port Project under ``root`` with experiment ``e`` of seeded Na/Cl."""
    import lammps_analysis_tpu_torch as lt
    from lammps_analysis_tpu_torch.database import (
        PropertyInfo, SpeciesInfo, TrajectoryChunkData, TrajectoryMetadata,
    )
    from lammps_analysis_tpu_torch.file_io import ScriptInput

    prop = PropertyInfo("Positions", 3)
    species = [SpeciesInfo(name, n, [prop]) for name, n in zip(("Na", "Cl"), counts)]
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
        "e", timestep=0.002, units="metal", simulation_data=ScriptInput(chunk, meta, "seeded")
    )


def main_path(card: str) -> int:
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.ops import rdf_kernel
    from lammps_analysis_tpu_torch.ops.rdf import rdf_histogram_reference

    config.device = "cuda"
    kw = dict(number_of_configurations=64, cutoff=BENCH["cutoff"],
              number_of_bins=BENCH["n_bins"], plot=False)
    with tempfile.TemporaryDirectory() as root:
        exp = ingest(root, BENCH["counts"], 100, BENCH["box"][0], seed=2024)
        calculator = exp.run.RadialDistributionFunction
        rdf_kernel.launches = 0
        rdf_histogram_reference.calls = 0
        t0 = time.perf_counter()
        result = calculator(**kw)
        seconds = time.perf_counter() - t0
        launches, plain_calls = rdf_kernel.launches, rdf_histogram_reference.calls
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
        pairs_per_s = calculator.last_throughput_pairs_per_s
        phase(
            "3 main",
            f"RDF 64 frames x 10240 atoms x 500 bins: {seconds:.3f} s wall, "
            f"{launches} kernel launches, 0 plain calls, {pairs_per_s / 1e9:.3f} "
            f"Gpairs/s inside the calculator, on {card}",
        )
        again = exp.run.RadialDistributionFunction(**kw)
        if rdf_kernel.launches != launches or again.data_dict != result.data_dict:
            raise RuntimeError("main path: the second run was not a cache hit")
        phase("3 main", "second run: cache hit, no new launch")

    # the same path on a small input, on the card and on the CPU
    small = dict(counts=[300, 200], n_frames=10, box=15.0)
    kw = dict(number_of_configurations=10, cutoff=7.4, number_of_bins=100, plot=False)
    outputs = {}
    for device in ("cuda", "cpu"):
        config.device = device
        with tempfile.TemporaryDirectory() as root:
            exp = ingest(root, small["counts"], small["n_frames"], small["box"], seed=7)
            outputs[device] = exp.run.RadialDistributionFunction(**kw).data_dict
    config.device = "cuda"
    if outputs["cuda"] != outputs["cpu"]:
        raise RuntimeError("main path: g(r) on the card differs from the CPU's plain path")
    phase("3 main", "small input (300 + 200 atoms, 10 frames): card and CPU g(r) identical")
    return launches


def main() -> int:
    card = environment()
    build()
    kernels = kernel_vs_plain()
    launches = main_path(card)
    main_case = kernels["m main path 64x10240"]
    print(json.dumps({"kernels": [{
        "name": "rdf_histogram",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(k["max_diff"] for k in kernels.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
