"""darthbench: the end-to-end benchmark of the PyTorch/CUDA port of DARTH.

``python3 darthbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
result line. Everything that belongs to one configuration, traffic mix,
index kind or metric is a file of its own, found by the name the manifest
gives (see ``manifest``).
"""
