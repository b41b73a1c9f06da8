"""The port's benchmark: one cell of ``BENCHMARK.json`` per run of ``run.py``."""
