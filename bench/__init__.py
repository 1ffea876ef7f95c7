"""The port's benchmark: one cell of BENCHMARK.json run once (``bench/run.py``).

Everything here is found by name: a configuration in ``configs/``, a traffic
mix in ``workloads/`` (naming its driver in ``drivers/``), a cell's limits in
``limits/`` and a per-layer metric's reader in ``metrics/``. Nothing under
``bench/`` imports ``jax``, the JAX package or ``benchmarks``; the plain
reference under ``reference/`` imports nothing of the port either.
"""
