"""The general machinery of the benchmark: it finds each configuration,
traffic mix, limit file and per-layer metric by its name in
``BENCHMARK.json``, so a cell or a metric is added by adding files."""
