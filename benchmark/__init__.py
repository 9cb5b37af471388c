"""The benchmark of the PyTorch and CUDA port (``dmlc_core_tpu_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once.  Everything a
cell needs is found by name: its configuration's file (``configs/``), its
traffic mix (``traffic/<mix>.json``, read by the runner the mix names in
``runners/``), and each per-layer metric's reader (``metrics/<metric>.py``).
The yardstick lives here too: the data generators (``gen/``), the plain
references (``reference/``) and the byte and FLOP counts
(``roofline/``).  Nothing here imports JAX or the JAX package.
"""
