"""The benchmark of the PyTorch and CUDA port (jdeflate_tpu_torch): run.py
runs one cell of BENCHMARK.json; see PERF.md."""
