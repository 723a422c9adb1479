"""Benchmark harness of ``cugraph_tpu_torch`` on NVIDIA cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON
result as its last line of standard output.  Everything a cell needs is
found by name: its configuration (``configs/``), its traffic mix
(``traffic/``), its judged reference and limits (``workloads/``), the entry
that drives the program (``entries/``), the plain reference
(``reference/``) and one reader per metric (``metrics/``).  Nothing here
imports JAX or the JAX package; ``reference/`` imports nothing of the port.
"""
