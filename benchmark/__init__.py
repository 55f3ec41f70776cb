# The benchmark of ctrlhair_tpu_torch on one NVIDIA H100: run.py is the
# entry point, BENCHMARK.json at the checkout's root the manifest.
