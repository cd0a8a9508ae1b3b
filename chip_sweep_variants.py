"""Times variants of the sweep kernel against each other on one card.

    python3 chip_sweep_variants.py VARIANT [VARIANT ...]

Each VARIANT is a copy of ``lammps_analysis_tpu_torch/csrc/adf_neighbor_extract.cu``
with changes joined by ``+``; ``checkout`` is the file as it is:

* ``warps=N``, ``cpw=N``, ``tile=N``, ``stages=N``: another block shape
  (warps a block, centers a warp), j tile or number of tile buffers;
* ``nopin``: without ``pin()``, so the compiler may recompute pinned values;
* ``rint-magic``: the minimum image's ``rintf`` as ``(x + 1.5 * 2^23) -
  1.5 * 2^23`` (equal only where ``|x| < 2^22``; a probe of the rounding
  unit's share, not a kernel to keep);
* ``nohit``: skips the kept path (the lists come out wrong; a probe of the
  tests' own time);
* ``file=PATH``: another source with the same C interface, such as a
  parent commit's kernel.

Every variant is built with the port's nvcc flags into
``lammps_analysis_tpu_torch/_build/variants/`` (ptxas registers printed),
run on the cases of the sweep's six modes at ``chip_smoke.py``'s shapes
(the full sweep at 1 x 10240 atoms, the first of two center stripes at 8 x
10240, ``idx`` at 16 x 10240, open boundaries on 2 frames of the droplet,
the z and brick windows at 2 x 32768 atoms, K = 1024), held to the
checkout's kernel output by output (a probe that differs says so), and
timed with CUDA events around back-to-back launches, allocation included,
in turns (forward, then backward, three times): the minimum of the six
rounds, ms a launch. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import pathlib
import re
import subprocess
import sys

import torch

import chip_smoke
from lammps_analysis_tpu_torch import _build
from lammps_analysis_tpu_torch.ops import adf_kernel, sorting
from lammps_analysis_tpu_torch.parallel.sharded_ops import AdfPlan

SOURCE = _build.CSRC / "adf_neighbor_extract.cu"
OUT = _build.BUILD_DIR / "variants"
RINT_MAGIC = """
__device__ __forceinline__ float displacement_rint(float x) {
  const float m = 12582912.f;  // 1.5 * 2^23
  return __fsub_rn(__fadd_rn(x, m), m);
}
template <bool kPeriodic>
__device__ __forceinline__ float displacement(float xj, float xi, float b, float ib) {
  const float dx = __fsub_rn(xj, xi);
  return kPeriodic ? __fsub_rn(dx, __fmul_rn(b, displacement_rint(__fmul_rn(dx, ib)))) : dx;
}
"""


def _replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise ValueError(f"the kernel source has no {old!r}")
    return text.replace(old, new)


def variant_source(name: str) -> str:
    """The source of ``name`` (see the module docstring)."""
    text = SOURCE.read_text()
    for part in name.split("+"):
        key, _, value = part.partition("=")
        constants = {"warps": "kWarps", "cpw": "kCentersPerWarp", "tile": "kJTile",
                     "stages": "kStages"}
        if key == "checkout":
            continue
        if key in constants:
            text, n = re.subn(rf"constexpr int {constants[key]} = \d+;",
                              f"constexpr int {constants[key]} = {int(value)};", text)
            if n != 1:
                raise ValueError(f"the kernel source has no {constants[key]}")
        elif key == "nopin":
            text = _replace(text, '  asm volatile("" : "+r"(x));\n', "")
        elif key == "rint-magic":
            start = text.index("template <bool kPeriodic>\n__device__ __forceinline__ float displacement")
            text = text[:start] + RINT_MAGIC + text[text.index("}\n", start) + 2:]
        elif key == "nohit":
            old = "if (!__any_sync(0xffffffffu, any)) continue;"
            text = _replace(text, old, old + " if (jstep >= 0) continue;")
        elif key == "file":
            text = pathlib.Path(value).read_text()
        else:
            raise ValueError(f"unknown variant {part!r}")
    return text


def build(name: str):
    """The variant's launch function, and its ptxas register counts."""
    tag = re.sub(r"[^A-Za-z0-9]+", "_", name)
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{tag}.cu", OUT / f"lib{tag}.so"
    src.write_text(variant_source(name))
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
                           "-o", str(lib), str(src)], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{done.stdout}{done.stderr}")
    fn = ctypes.CDLL(str(lib)).adf_neighbor_extract_launch
    fn.argtypes = adf_kernel._library().adf_neighbor_extract_launch.argtypes
    fn.restype = ctypes.c_int
    return fn, re.findall(r"Used (\d+) registers", done.stdout + done.stderr)


def launch(fn, pos, sid, box, cutoff, k_n, c0, c1, with_idx, arcs=None):
    """One launch through ``fn`` as ``adf_kernel._launch_sweep`` makes it."""
    (bx, by, bz), (ibx, iby, ibz), t, _ = adf_kernel._extract_geometry(adf_kernel._box_key(box), cutoff)
    n_frames, n_atoms, _ = pos.shape
    size = n_frames * (c1 - c0) * k_n
    out, _, ints = adf_kernel._empty_lists(n_frames, c1 - c0, k_n, pos.device,
                                           extra_ints=(size if with_idx else 0) + 1)
    overflow = ints[-1:].zero_()
    err = fn(pos.data_ptr(), sid.data_ptr(), *(x.data_ptr() for x in out),
             ints.data_ptr() if with_idx else None, n_frames, n_atoms, 2, k_n, c0, c1 - c0,
             n_atoms if sid.dim() == 2 else 0, int(box is not None),
             arcs.data_ptr() if arcs is not None else None, 0 if arcs is None else arcs.shape[1] // 2,
             1 << 40, overflow.data_ptr(), bx, by, bz, ibx, iby, ibz, t,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return (*out, ints[:size]) if with_idx else out


def cases() -> dict:
    """``{label: (launch arguments, launches a round)}`` of the six modes."""
    dev = torch.device("cuda")
    a, w = chip_smoke.ADF, chip_smoke.WIDE
    pos, sid = chip_smoke.make_case(a["counts"], 16, a["box"], 80, dev)
    n = pos.shape[1]
    k_n = AdfPlan(n, a["box"], a["cutoff"]).k_n
    first_shell = dict(sid=sid, box=a["box"], cutoff=a["cutoff"], k_n=k_n, c0=0)
    found = {
        "sweep 1 x 10240": (dict(first_shell, pos=pos[:1].contiguous(), c1=n, with_idx=False), 50),
        "stripe 8 x 10240": (dict(first_shell, pos=pos[:8].contiguous(), c1=n // 2, with_idx=False), 10),
        "idx 16 x 10240": (dict(first_shell, pos=pos, c1=n, with_idx=True), 5),
    }
    dpos, dsid = chip_smoke.droplet(2, 82, dev)
    found["open 2 x 10240"] = (dict(pos=dpos, sid=dsid, box=None, cutoff=chip_smoke.DROPLET["cutoff"],
                                    k_n=chip_smoke.DROPLET["k_n"], c0=0, c1=dpos.shape[1],
                                    with_idx=False), 20)
    wpos, wsid = chip_smoke.make_case(w["counts"], 2, w["box"], 83, dev)
    for sort in ("z", "brick"):
        pos_s, sid_s, _, arcs, _ = sorting.sort_frames(wpos, wsid, 2, w["box"], w["cutoff"], sort)
        found[f"sorted {sort} 2 x 32768"] = (dict(
            pos=pos_s, sid=sid_s.to(torch.int32).contiguous(), box=w["box"], cutoff=w["cutoff"],
            k_n=w["k_n"], c0=0, c1=pos_s.shape[1], with_idx=False, arcs=arcs.contiguous()), 5)
    return found


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_power_line(), flush=True)
    fns = {}
    for name in names:
        fns[name], registers = build(name)
        print(f"{name}: ptxas registers {registers}", flush=True)
    checkout = adf_kernel._library().adf_neighbor_extract_launch
    for label, (kw, reps) in cases().items():
        reference = launch(checkout, **kw)
        for name, fn in fns.items():
            if not all(torch.equal(x, y) for x, y in zip(launch(fn, **kw), reference)):
                print(f"  {label}: {name} differs from the checkout's kernel", flush=True)
        times = {name: [] for name in fns}
        for _ in range(3):
            for name, fn in list(fns.items()) + list(reversed(fns.items())):
                times[name].append(chip_smoke.time_ms(lambda: launch(fn, **kw), reps))
        print(f"{label}: ms a launch, min of 6 rounds: "
              + ", ".join(f"{name} {min(t):.4f}" for name, t in times.items()), flush=True)
        del reference
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or ["checkout"]))
