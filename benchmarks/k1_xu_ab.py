"""K1's pair loop in variants of its source, counted and timed side by side on one card.

    python3 benchmarks/k1_xu_ab.py OUT VARIANT [VARIANT ...]

Each VARIANT is a copy of ``lammps_analysis_tpu_torch/csrc/rdf_histogram.cu``
with changes joined by ``+``; ``checkout`` is the file as it is:

* ``file=PATH``: another source with one of K1's three C interfaces, such
  as a parent commit's kernel (the source names ``unfolded_sweeps`` where
  its interface takes both sweep words and the fold, ``general_sweeps``
  where it takes the general word alone);
* ``rint-magic``: the minimum image's ``rintf`` as ``(q + 1.5 * 2^23) -
  1.5 * 2^23`` and its ``dx - b * r`` as one FMA, with no guard (exact only
  where ``|r| <= 2``, so only on wrapped positions: a probe of the
  rounding's share);
* ``bin-rd``: the bin's ``floorf`` and cast to ``int`` as ``2^23 +
  min(x, n_bins - 1)`` rounded down, read as an integer (a probe of the
  conversion's share);
* ``nofold``: the host never lets a warp fold the minimum image, so the
  in-box sequences take the fold's sweeps (a probe of the fold's share).

The patches apply to a source whose pair loop calls ``min_image`` on each
component and bins with ``floorf``, as the parent's does.

Every variant is built with the port's nvcc flags into
``lammps_analysis_tpu_torch/_build/k1_variants/`` (ptxas' registers
printed) and disassembled with ``cuobjdump -sass`` into ``OUT``: for each
instantiation of the kernel, the counts of ``FRND``, ``F2I``, ``MUFU``,
shared reductions and all instructions, and for each of its pair loops
(``pair_loops``) the instructions a pair and the route they take. Then
each variant runs the cases: LJ's shape (LAMMPS' in.lj as ``lj_melt_32k``
holds it: 32 frames x 32000 atoms, 114.38 A box, cutoff 57.09 A, 5709
bins), NaCl's (``nacl_melt_32k``: 32 frames x 2 x 16000 ions, 104.04 A box,
cutoff 51.92 A, 5192 bins, 3 pair rows), LJ's shape centred on the origin
(8 frames; the fold's guard sends the sweeps to the in-box sequences) and
moved two boxes out in x (8 frames; both guards send them to the general
sequences). Each run is held to
``rdf_histogram_reference`` bin for bin, then timed with CUDA events around
5 back-to-back launches (the histogram zeroed before each), in turns
(forward, then backward, three times): the least and the median of the six
rounds, ms a launch, G pair tests/s at the least, and the launch's sweeps
by the general and the unfolded in-box sequences. One JSON line a variant
and case goes to ``OUT/k1_xu_ab.jsonl``, one a variant and pair loop to
``OUT/k1_pair_loops.jsonl``. Needs a CUDA card, nvcc and cuobjdump; run
from the root of a checkout, such as a parent commit's kernel against this
one:

    git show HEAD~1:lammps_analysis_tpu_torch/csrc/rdf_histogram.cu > _local/parent.cu
    python3 benchmarks/k1_xu_ab.py _local/k1 file=_local/parent.cu checkout
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from lammps_analysis_tpu_torch import _build  # noqa: E402
from lammps_analysis_tpu_torch.ops.geometry import squared_cutoff  # noqa: E402
from lammps_analysis_tpu_torch.ops.rdf import (  # noqa: E402
    build_species_layout,
    rdf_histogram_reference,
    rdf_scalars,
)
from lammps_analysis_tpu_torch.ops.rdf_kernel import folds  # noqa: E402

SOURCE = _build.CSRC / "rdf_histogram.cu"
BUILD = _build.BUILD_DIR / "k1_variants"

RINT_MAGIC = """
__device__ __forceinline__ float min_image_magic(float dx, float b, float ib) {
  const float q = __fmul_rn(dx, ib);
  const float r = __fsub_rn(__fadd_rn(q, 12582912.f), 12582912.f);
  return __fmaf_rn(-b, r, dx);
}
"""
BIN_FLOOR = "min(static_cast<int>(floorf(__fmul_rn(d, p.inv_bin))), p.n_bins - 1)"
BIN_RD = ("(__float_as_int(__fadd_rd(fminf(__fmul_rn(d, p.inv_bin), "
          "static_cast<float>(p.n_bins - 1)), 8388608.f)) - 0x4B000000)")

#: per case: species counts, frames, the cubic box's edge, cutoff, bins, and
#: a shift of the wrapped positions in boxes, by axis
CASES = {
    "lj": dict(counts=[32000], n_frames=32, box=114.38, cutoff=57.09, n_bins=5709,
               shift=(0, 0, 0)),
    "nacl": dict(counts=[16000, 16000], n_frames=32, box=104.04, cutoff=51.92, n_bins=5192,
                 shift=(0, 0, 0)),
    "lj-global": dict(counts=[32000], n_frames=4, box=114.38, cutoff=57.09, n_bins=60000,
                      shift=(0, 0, 0)),
    "lj-centred": dict(counts=[32000], n_frames=8, box=114.38, cutoff=57.09, n_bins=5709,
                       shift=(-0.5, -0.5, -0.5)),
    "lj-out": dict(counts=[32000], n_frames=8, box=114.38, cutoff=57.09, n_bins=5709,
                   shift=(2, 0, 0)),
}


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"variant patch: {old!r} not in the source")
    return text.replace(old, new)


def variant_source(name: str) -> str:
    text = SOURCE.read_text()
    for part in name.split("+"):
        if part == "checkout":
            continue
        if part.startswith("file="):
            text = pathlib.Path(part[5:]).read_text()
        elif part == "rint-magic":
            text = _replace(text, '#include "pair_math.cuh"\n',
                            '#include "pair_math.cuh"\n' + RINT_MAGIC)
            text = re.sub(r"= min_image\(", "= min_image_magic(", text)
        elif part == "bin-rd":
            text = _replace(text, BIN_FLOOR, BIN_RD)
        elif part == "nofold":
            text = _replace(text, "box_ok && fold != 0,", "false,")
        else:
            raise ValueError(f"unknown variant part {part!r}")
    return text


def build(name: str, out: pathlib.Path):
    """The variant's library and ptxas' lines on its kernels; its SASS counts
    by instantiation."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = re.sub(r"[^A-Za-z0-9_.-]", "_", name)[-80:]
    src = BUILD / f"{tag}.cu"
    src.write_text(variant_source(name))
    lib = BUILD / f"lib{tag}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
           "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    ptxas = [line.strip() for line in (done.stdout + done.stderr).splitlines()
             if "registers" in line or "spill" in line or "Compiling entry" in line]
    cuobjdump = pathlib.Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    (out / f"{tag}.sass").write_text(sass)
    return ctypes.CDLL(str(lib)), ptxas, sass_counts(sass), pair_loops(sass)


def _instructions(sass: str) -> dict:
    """Per kernel function in a ``cuobjdump -sass`` listing: its
    instructions as (address, opcode, operands)."""
    functions, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            functions[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)", line)
        if name is not None and m:
            functions[name].append((int(m.group(1), 16), m.group(2), m.group(3)))
    return functions


def pair_loops(sass: str) -> dict:
    """Per kernel function: its innermost loops that count pairs, each as
    ``{"instructions", "pairs", "per_pair", "route", ...}``.

    A loop is the range from a backward branch's target to the branch; an
    innermost one holds no other, and a pair loop takes square roots
    (``MUFU``). Its pairs are its shared reductions (``ATOMS``), or its
    global ones (``RED``) where it has none: one a pair. ``per_pair`` counts
    the instructions a sweep issues for each pair: the loop's less the
    ``cold`` ones, those that a forward branch inside it skips with no
    pair's reduction among them (the species row, recomputed about once a
    tile). A kept path counts whole, since a warp runs it whenever one of
    its lanes keeps the pair. Its route: ``general`` where it rounds
    (``FRND``), ``fold`` where it has at least 4 ``FMNMX`` a pair (3 folds,
    the bin's clamp), else ``in-box``.
    """
    out = {}
    for name, code in _instructions(sass).items():
        loops = []
        for address, op, operands in code:
            m = re.search(r"0x([0-9a-f]+)", operands)
            if op.startswith("BRA") and m and int(m.group(1), 16) < address:
                loops.append((int(m.group(1), 16), address))
        inner = [(a, b) for a, b in loops
                 if not any((a, b) != (c, d) and a <= c and d <= b for c, d in loops)]
        found = []
        for a, b in sorted(inner):
            body = [(address, op, operands) for address, op, operands in code
                    if a <= address <= b]
            ops = [op for _, op, _ in body]
            c = {key: sum(op.startswith(key) for op in ops)
                 for key in ("FRND", "FMNMX", "FADD", "FFMA", "FMUL", "MUFU", "ATOMS", "RED",
                             "ISETP")}
            pairs = c["ATOMS"] or c["RED"]
            if not pairs or not c["MUFU"]:
                continue
            cold = set()
            for address, op, operands in body:
                m = re.search(r"0x([0-9a-f]+)", operands)
                if op.startswith("BRA") and m and address < int(m.group(1), 16) <= b:
                    skipped = [x for x in body if address < x[0] < int(m.group(1), 16)]
                    if not any(x[1].startswith(("ATOMS", "RED")) for x in skipped):
                        cold.update(x[0] for x in skipped)
            route = ("general" if c["FRND"] else
                     "fold" if c["FMNMX"] >= 4 * pairs else "in-box")
            found.append(dict(start=hex(a), end=hex(b), instructions=len(ops), cold=len(cold),
                              pairs=pairs, per_pair=(len(ops) - len(cold)) / pairs,
                              route=route, **c))
        if found:
            out[name] = found
    return out


def sass_counts(sass: str) -> dict:
    """Per kernel function in a ``cuobjdump -sass`` listing: instructions in
    all, those of the XU (``FRND``, ``F2I``, ``MUFU``), the shared atomics
    (``ATOMS``) and the global ones (``RED``, ``ATOMG``)."""
    counts = {}
    for name, code in _instructions(sass).items():
        ops = [op for _, op, _ in code]
        counts[name] = dict(total=len(ops),
                            **{key: sum(op.startswith(key) for op in ops)
                               for key in ("FRND", "F2I", "MUFU", "ATOMS")},
                            RED=sum(op.startswith(("RED.", "ATOMG")) for op in ops))
    return counts


def make_case(c: dict, seed: int):
    sid, n_pad, _, _, _ = build_species_layout(c["counts"], pad_to=8)
    rng = np.random.default_rng(seed)
    n = sum(c["counts"])
    pos = np.zeros((c["n_frames"], n_pad, 3), np.float32)
    pos[:, :n] = rng.uniform(0.0, 1.0, (c["n_frames"], n, 3)) * c["box"]
    pos[:, :n] += (np.float32(c["box"]) * np.float32(c["shift"])).astype(np.float32)
    return (torch.from_numpy(pos).cuda(), torch.from_numpy(sid).cuda())


def interface(source: str) -> int:
    """K1's C interface in ``source``: 2 takes both sweep words and the
    fold, 1 the general-sweep word alone, 0 neither."""
    return 2 if "unfolded_sweeps" in source else 1 if "general_sweeps" in source else 0


def launcher(lib: ctypes.CDLL, version: int, pos, sid, c: dict, words):
    fn = lib.rdf_histogram_launch
    fn.argtypes = ([ctypes.c_void_p] * (3 + version) + [ctypes.c_int64] * 6
                   + [ctypes.c_float] * 8 + [ctypes.c_int] * (version == 2) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    n_species = len(c["counts"])
    box = (c["box"],) * 3
    (bx, by, bz), (ibx, iby, ibz), cut, inv_bin = rdf_scalars(box, c["cutoff"], c["n_bins"])
    t = squared_cutoff(cut)
    n_pairs = n_species * (n_species + 1) // 2
    out = torch.zeros((n_pairs, c["n_bins"]), dtype=torch.int64, device="cuda")
    n_frames, n_atoms, _ = pos.shape
    ptrs = [pos.data_ptr(), sid.data_ptr(), out.data_ptr()]
    ptrs += [words[k].data_ptr() for k in range(version)]
    fold = [int(folds(box, c["cutoff"], c["n_bins"]))] * (version == 2)
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        out.zero_()
        err = fn(*ptrs, n_frames, n_atoms, n_species, c["n_bins"], 0, n_atoms,
                 bx, by, bz, ibx, iby, ibz, t, inv_bin, *fold, stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    return launch


def time_ms(launch, reps: int = 5) -> float:
    launch()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv: list[str]) -> int:
    out = pathlib.Path(argv[0])
    out.mkdir(parents=True, exist_ok=True)
    names = argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    libs, loop_lines = {}, []
    for name in names:
        try:
            lib, ptxas, counts, loops = build(name, out)
        except Exception as exc:  # noqa: BLE001 - report and go on with the others
            print(f"[build] {name}: FAILED {exc}", flush=True)
            continue
        libs[name] = (lib, interface(variant_source(name)))
        print(f"[build] {name}: " + " | ".join(ptxas), flush=True)
        for fn, c in counts.items():
            if "rdf_histogram_kernel" in fn:
                print(f"[sass] {name} {fn}: {json.dumps(c)}", flush=True)
        for fn, found in loops.items():
            for loop in found:
                loop_lines.append(dict(variant=name, function=fn, **loop))
                print(f"[loop] {name} {fn}: {loop['route']} {loop['instructions']} "
                      f"instructions ({loop['cold']} cold), {loop['pairs']} pairs, "
                      f"{loop['per_pair']:.2f} a pair "
                      f"{json.dumps({k: loop[k] for k in ('FMNMX', 'FADD', 'FFMA', 'FMUL', 'ISETP')})}",
                      flush=True)
    with open(out / "k1_pair_loops.jsonl", "w") as f:
        for line in loop_lines:
            f.write(json.dumps(line) + "\n")
    lines = []
    for case_name, c in CASES.items():
        pos, sid = make_case(c, seed=20 + len(lines))
        args = (pos, sid, (c["box"],) * 3, c["cutoff"], c["n_bins"], len(c["counts"]))
        plain = rdf_histogram_reference(*args)
        n = sum(c["counts"])
        pair_tests = c["n_frames"] * n * (n - 1) / 2
        runs = {}
        for name, (lib, version) in libs.items():
            if any(c["shift"]) and "rint-magic" in name:
                continue  # the probe is exact on wrapped positions alone
            words = torch.zeros(2, dtype=torch.int64, device="cuda")
            launch = launcher(lib, version, pos, sid, c, words)
            equal = torch.equal(launch(), plain)
            torch.cuda.synchronize()
            sweeps = [int(w) for w in words.tolist()]
            runs[name] = dict(launch=launch, equal=equal, sweeps=sweeps, ms=[])
        order = list(runs)
        for rnd in range(6):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                runs[name]["ms"].append(time_ms(runs[name]["launch"]))
        for name, r in runs.items():
            line = dict(case=case_name, variant=name, equal=r["equal"],
                        general_sweeps=r["sweeps"][0], unfolded_sweeps=r["sweeps"][1], ms=r["ms"],
                        min_ms=min(r["ms"]), median_ms=statistics.median(r["ms"]),
                        gpairs_per_s=pair_tests / min(r["ms"]) / 1e6, card=card)
            lines.append(line)
            print(f"[time] {case_name} {name}: equal={r['equal']} min {line['min_ms']:.4f} "
                  f"median {line['median_ms']:.4f} ms, {line['gpairs_per_s']:.1f} G pairs/s, "
                  f"general sweeps {line['general_sweeps']}, unfolded "
                  f"{line['unfolded_sweeps']} (one launch)", flush=True)
        del pos, sid, plain, runs
        torch.cuda.empty_cache()
    with open(out / "k1_xu_ab.jsonl", "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0 if all(line["equal"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
