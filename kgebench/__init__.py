"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One run measures one cell of ``BENCHMARK.json`` once:

    python3 -m kgebench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``, the
generator of the mix's kind in ``kinds/<kind>.py`` and each per-layer metric's
reader in ``metrics/<metric>.py``. The yardstick (the inputs drawn from the
seed, the plain reference, the work formulas, the H100's peaks and the reading
of the profiler's trace) lives here too, apart from the program it measures.
"""
