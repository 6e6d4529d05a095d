"""The benchmark of the PyTorch and CUDA FALKON port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once on one H100 and prints one JSON
result line. Everything a cell needs is found by name: its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``) and
the code of the mix's kind (``kinds/<kind>.py``), its correctness limits
(``limits/<cell>.json``) and one reader per metric (``metrics/<metric>.py``).
The frozen operation and byte counts are in ``counts/``, the plain float64
reference in ``reference/``. Nothing here imports ``jax`` or the JAX
package.
"""
