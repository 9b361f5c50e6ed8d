"""The benchmark of the PyTorch port: `python3 flowbench/run.py --workload <cell> ...`
(see run.py, and PERF.md for the cells, metrics and limits)."""
