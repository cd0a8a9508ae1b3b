"""The control of a cell's correctness check: the plain reference put in the
program's place and computed one precision lower (bfloat16 for the
float32 that the port computes in; sums stay wide), judged against the
reference by the cell's own judge.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed with each number compared and its limit, then
the least reading of each number over the seeds: the upper reading that a
limit has to stay below. Runs on the card at the cell's own size; the
benchmark's runs never run it.
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

CONTROL_DTYPE = "bfloat16"


def readings(cell, seed: int, device: str) -> dict:
    """Each number of ``cell``'s judge for the control on ``seed``'s inputs:
    both sides receive the generator's output as it returned it (the
    positions, or a mapping of named properties)."""
    import torch

    inputs = cell.generator().generate(cell.config, seed, device)
    reference = cell.reference()
    args = cell.traffic["args"]
    ref_answer, work = reference.compute(inputs, cell.config, args)
    control, _ = reference.compute(inputs, cell.config, args,
                                   dtype=getattr(torch, CONTROL_DTYPE))
    return reference.judge(control, ref_answer, work)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)

    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("portbench control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.find_cell(args.workload)
    least = {}
    for seed in args.seeds:
        numbers = readings(cell, seed, "cuda")
        for name, value in numbers.items():
            least[name] = min(least.get(name, float("inf")), value)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": CONTROL_DTYPE,
                          "numbers": numbers, "limits": cell.limits}), flush=True)
    print(json.dumps({"workload": cell.name, "control": CONTROL_DTYPE, "least": least,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
