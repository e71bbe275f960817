"""The benchmark of ``fit_tpu_torch`` on an NVIDIA H100.

``python -m bench_torch.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one cell, configuration, traffic mix
or per-layer metric is a file of its own under this directory, found by
its name: ``workloads/<cell>.json``, ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py``. The yardstick (FLOP and byte counts, the peaks,
the trace reduction, the plain fp32 reference under ``reference/`` and the
comparison that decides ``correct``) lives here too; nothing here imports
the JAX package.
"""
