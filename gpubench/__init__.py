"""The benchmark of the PyTorch / CUDA port: a harness driven by
BENCHMARK.json and the files named there (see run.py)."""
