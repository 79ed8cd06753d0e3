"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
command runs one cell once (``python3 bench/run.py --workload <name> --seed
<n> --seconds <s> --trace <0|1>``) and prints one JSON line.  See PERF.md."""
