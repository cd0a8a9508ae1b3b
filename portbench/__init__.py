"""Benchmark of ``lammps_analysis_tpu_torch`` on an NVIDIA GPU.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Everything
a cell needs is found by name: ``configs/<config>.json`` and
``configs/<config>.py`` (sizes and the seeded input generator),
``traffic/<mix>.json`` (the calculator call), ``cells/<cell>.json`` (the
limits of the correctness check), ``reference/<module>.py`` (the plain
reference and its judge), ``metrics/<metric>.py`` (per-layer readers) and
``counts/<kernel>.py`` (frozen work counts). ``ADDING.md`` says how to add each.
"""
