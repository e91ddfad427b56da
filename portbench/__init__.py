"""The benchmark of ``fenet_torch`` on one NVIDIA H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell once and prints one JSON result line. A cell is an
entry of ``BENCHMARK.json`` with its file in ``workloads/``; model
configurations, traffic kinds and per-layer metrics are files found by
name (``configs/``, ``traffic/``, ``metrics/``); the plain
reference that decides ``correct`` is ``reference/``, the operation and byte
counts behind the roofline and MFU figures are ``counts/``.
"""
