"""The benchmark of ``ipoke_tpu_torch``, the PyTorch and CUDA port of iPOKE,
on NVIDIA H100 cards.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Data-driven: a cell is ``workloads/<cell>.json`` (its configuration, its
traffic and the limits of its output check), a configuration
``configs/<config>.json``, a traffic mix ``traffic/<traffic>.json`` whose
``kind`` names its driver ``drivers/<kind>.py``, and each per-layer metric
named in ``BENCHMARK.json`` a reader ``metrics/<metric>.py``.  A later change
adds a cell, a configuration, a mix or a metric by adding files.
"""
