"""The port's benchmark: the counterpart of the JAX package's bench.py and
of its helper scripts (scripts/devtime.py, scripts/decode_capture.py,
scripts/scaling_probe.py).

Run it as ``python3 -m jdeflate_tpu_torch.bench``; it prints ONE JSON line
and writes its details to ``jdeflate_tpu_torch/_build/bench_details.json``.
Modules: corpus (the bench's corpus generator), devtime (cycled timing with
CUDA events and the profiler), capture (a decode batch's kernel inputs from
the codec's capture hooks), kernels (the per-kernel table), scaling (the
sharded-members row) and __main__ (run and main). Importing the package
imports nothing else.
"""
