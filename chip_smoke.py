#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lammps_analysis_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, one line each (any failure raises and the exit code is not 0):

0. environment: torch and CUDA versions, the card's name, compute capability
   and power limit, and which optional packages import (for the record: the
   port's main path needs none of them);
1. build: nvcc compiles ``lammps_analysis_tpu_torch/csrc/*.cu`` for sm_90a,
   one nvcc per source, side by side;
2. kernel vs plain, each kernel and its plain torch version on the same
   seeded inputs on the card, with both times (CUDA events, after a warm-up
   call):
   * ``[2 kernel]`` the RDF pair histogram, equal bin for bin;
   * ``[2 extract]`` the ADF neighbor extract, all six outputs equal;
   * ``[2 angles]`` the ADF angle histogram on those lists: totals within
     rtol 1e-5, at most max(2, size // 64) bins outside rtol 1e-4 (float32
     atomics add in another order);
3. main paths, each through ``Project`` -> in-memory ingest -> ``exp.run``,
   checked to go through its kernels and never the plain versions, to give
   the ideal gas's answer and to be a cache hit when run again, then run on
   a small input on the card and on the CPU, which must agree:
   * ``[3 main]`` the RDF, 64 frames x 10240 atoms, 500 bins;
   * ``[3 adf]`` the ADF, 16 frames x 10240 atoms, cutoff 3.6 A, 500 bins.

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

CSRC = "lammps_analysis_tpu_torch/csrc/"
REPLACES = {
    "rdf_histogram": "lammps_analysis_tpu/ops/pallas_rdf.py:85",
    "adf_neighbor_extract": "lammps_analysis_tpu/ops/pallas_adf.py:221",
    "adf_pairs_histogram": "lammps_analysis_tpu/ops/pallas_adf.py:1482",
}

# the bench workload of the JAX package: Na + Cl, box 40 A, cutoff 19.9 A
BENCH = dict(counts=[5120, 5120], box=(40.0, 40.0, 40.0), cutoff=19.9, n_bins=500)
# its ADF first-shell workload (bench.py:192-229): the same system, cutoff 3.6 A
ADF = dict(counts=[5120, 5120], box=(40.0, 40.0, 40.0), cutoff=3.6, n_bins=500)
ADF_RANGE = 3.15  # radians, ops/adf.py::ADF_BIN_RANGE


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


def adf_kernels_vs_plain() -> dict:
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import (
        adf_pairs_histogram_reference,
        neighbor_extract_reference,
    )
    from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfPlan

    d_box = 40.0 * 6.4 ** (1 / 3)  # 65536 atoms at the 10240-atom density
    extract_cases = {
        "a first shell 16x10240": dict(ADF, n_frames=16, reps=(20, 2)),
        "b 3 species N=1000, padding, id >= S": dict(
            counts=[400, 350, 245], box=(30.0, 33.0, 36.0), cutoff=5.9,
            n_frames=3, reps=(20, 3),
        ),
        "c dense cluster, counts above K": dict(
            counts=[2000], box=(10.0, 10.0, 10.0), cutoff=4.9, k_n=128,
            n_frames=2, reps=(10, 2),
        ),
        "d 2x65536": dict(
            counts=[32768, 32768], box=(d_box,) * 3, cutoff=3.6, n_frames=2,
            reps=(10, 2),
        ),
    }
    device = torch.device("cuda")
    lists, results = {}, {}
    for seed, (label, c) in enumerate(extract_cases.items(), start=10):
        pos, sid = make_case(c["counts"], c["n_frames"], c["box"], seed, device)
        n_species = len(c["counts"])
        if label.startswith("b"):
            sid[10:13] = n_species  # out of range: padding, as the kernel reads it
        k_n = c.get("k_n") or AdfPlan(pos.shape[1], c["box"], c["cutoff"]).k_n
        args = (pos, sid, c["box"], c["cutoff"], k_n, n_species)
        ours = adf_kernel.neighbor_extract(*args)
        plain = neighbor_extract_reference(*args)
        torch.cuda.synchronize()
        for name, a, b in zip(("rx", "ry", "rz", "d", "sid", "counts"), ours, plain):
            if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
                raise RuntimeError(f"extract {label}: {name} differs from the plain version")
        counts = plain[5]
        max_count = int(counts.max())
        if max_count < 2 or (label.startswith("c") and max_count <= k_n):
            raise RuntimeError(f"extract {label}: largest count {max_count} at K={k_n}")
        ms = time_ms(lambda: adf_kernel.neighbor_extract(*args), c["reps"][0])
        plain_ms = time_ms(lambda: neighbor_extract_reference(*args), c["reps"][1])
        n = sum(c["counts"])
        tests = c["n_frames"] * n * n
        phase(
            "2 extract",
            f"{label}: K={k_n}, mean count {float(counts.float().mean()):.2f}, "
            f"largest {max_count}, all six outputs equal, kernel {ms:.3f} ms "
            f"({tests / ms / 1e6:.2f} G distance tests/s), plain {plain_ms:.3f} ms",
        )
        results[f"extract {label}"] = dict(max_diff=0.0, ms=ms, plain_ms=plain_ms)
        lists[label[0]] = (ours, sid, n_species)
        del plain

    angle_cases = {
        "a 2 species x 500 bins, p=4": ("a", 500, 4, True, (20, 2)),
        "a p=0": ("a", 500, 0, True, (5, 1)),
        "b 10 triples x 500 bins": ("b", 500, 4, True, (5, 1)),
        "b global atomics, 10 triples x 6000 bins": ("b", 6000, 2, False, (5, 1)),
        "c saturated lists": ("c", 500, 4, True, (5, 1)),
        "d 2x65536": ("d", 500, 4, True, (10, 2)),
    }
    for label, (key, n_bins, p, shared, reps) in angle_cases.items():
        (rx, ry, rz, d, sid_n, counts), sid, n_species = lists[key]
        args = (rx, ry, rz, d, sid_n, counts, sid, n_bins, n_species, p)
        uses_shared = adf_kernel.pairs_histogram_uses_shared(n_species, n_bins, rx.shape[2])
        if uses_shared != shared:
            raise RuntimeError(f"angles {label}: expected shared={shared}, got {uses_shared}")
        ours = adf_kernel.adf_pairs_histogram(*args)
        plain = adf_pairs_histogram_reference(*args)
        torch.cuda.synchronize()
        max_diff = check_hist(f"angles {label}", ours.cpu().numpy(), plain.cpu().numpy())
        ms = time_ms(lambda: adf_kernel.adf_pairs_histogram(*args), reps[0])
        plain_ms = time_ms(lambda: adf_pairs_histogram_reference(*args), reps[1])
        listed = counts.clamp(max=rx.shape[2]).double()
        pairs = float((listed * (listed - 1) / 2).sum())
        phase(
            "2 angles",
            f"{label}: {'shared' if shared else 'global'} histogram, total "
            f"{float(plain.double().sum()):.6g}, max |diff| {max_diff:.3g}, kernel "
            f"{ms:.3f} ms ({pairs / ms / 1e6:.2f} G pair angles/s), plain {plain_ms:.3f} ms",
        )
        results[f"angles {label}"] = dict(max_diff=max_diff, ms=ms, plain_ms=plain_ms)
    del lists
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


def adf_main_path(card: str) -> dict:
    from lammps_analysis_tpu_torch import config
    from lammps_analysis_tpu_torch.memory.planner import BatchPlanner
    from lammps_analysis_tpu_torch.ops import adf_kernel
    from lammps_analysis_tpu_torch.ops.adf import (
        adf_pairs_histogram_reference,
        neighbor_extract_reference,
    )

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
        adf_kernel.neighbor_extract.launches = 0
        adf_kernel.adf_pairs_histogram.launches = 0
        neighbor_extract_reference.calls = 0
        adf_pairs_histogram_reference.calls = 0
        t0 = time.perf_counter()
        result = calculator(**kw)
        seconds = time.perf_counter() - t0
        launches = {
            "adf_neighbor_extract": adf_kernel.neighbor_extract.launches,
            "adf_pairs_histogram": adf_kernel.adf_pairs_histogram.launches,
        }
        plain_calls = neighbor_extract_reference.calls + adf_pairs_histogram_reference.calls
        if min(launches.values()) < 1 or plain_calls != 0:
            raise RuntimeError(
                f"adf main path: kernel launches {launches} and {plain_calls} plain "
                "calls; it must go through the kernels alone"
            )
        n_batches = calculator.last_n_batches
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
            f"{n_batches} batches, K={calculator.last_k_n}, {calculator.last_n_passes} "
            f"pass(es), launches {launches}, 0 plain calls, "
            f"{calculator.last_throughput_pairs_per_s / 1e9:.3f} G atom pairs/s inside "
            f"the calculator, every triple finite and integrating to {n_batches}, on {card}",
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

        before = (adf_kernel.neighbor_extract.launches, adf_kernel.adf_pairs_histogram.launches)
        again = exp.run.AngularDistributionFunction(**kw)
        after = (adf_kernel.neighbor_extract.launches, adf_kernel.adf_pairs_histogram.launches)
        if after != before or again.data_dict != result.data_dict:
            raise RuntimeError("adf main path: the second run was not a cache hit")
        phase("3 adf", "second run: cache hit, no new launch")

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
    return launches


def kernel_record(name: str, launches: int, cases: list, main: dict) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": CSRC + name + ".cu",
        "replaces": REPLACES[name],
        "launches": launches,
        "max_abs_err": max(c["max_diff"] for c in cases),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
    }


def main() -> int:
    card = environment()
    build()
    rdf = kernel_vs_plain()
    adf = adf_kernels_vs_plain()
    rdf_launches = main_path(card)
    adf_launches = adf_main_path(card)
    extract = [v for k, v in adf.items() if k.startswith("extract")]
    angles = [v for k, v in adf.items() if k.startswith("angles")]
    print(json.dumps({"kernels": [
        kernel_record("rdf_histogram", rdf_launches, list(rdf.values()),
                      rdf["m main path 64x10240"]),
        kernel_record("adf_neighbor_extract", adf_launches["adf_neighbor_extract"],
                      extract, adf["extract a first shell 16x10240"]),
        kernel_record("adf_pairs_histogram", adf_launches["adf_pairs_histogram"],
                      angles, adf["angles a 2 species x 500 bins, p=4"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
