"""The benchmark of ``linkpred_tpu_torch`` on one NVIDIA H100.

One command runs one cell once::

    python3 -m lpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<mix>.json``,
``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``.
"""
