"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Everything the harness knows of a
cell comes from files found by name: ``configs/<config>.json`` (the
deployment), ``workloads/<cell>.json`` (the traffic), ``metrics/<metric>.py``
(one reader per per-layer metric) and ``systems/<system>.py`` (the driver of
a kind of deployment, named by the configuration). ``reference/`` holds the
plain models that decide ``correct``; it imports nothing of the program.
"""
