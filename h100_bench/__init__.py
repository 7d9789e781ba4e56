"""The benchmark of the PyTorch and CUDA port (``transflow_tpu_torch``) on
one NVIDIA H100, driven by ``BENCHMARK.json``.

``python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``). A cell's configuration
is ``configs/<name>.json``, its traffic ``traffic/<name>.json``, each
per-layer metric ``metrics/<name>.py``; ``reference/`` holds the plain
reference that decides ``correct`` (``check.py``), ``rooflines.py`` the
card's peaks and the kernels' bounds. ``python3 -m h100_bench.control``
reads the control's numbers. The tests: ``python -m pytest
h100_bench/tests`` (the card's: ``--noconftest``, marker ``cuda``).
"""
