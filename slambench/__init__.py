"""slambench: the benchmark of nrslam_tpu_torch, the PyTorch and CUDA port
of nrslam_tpu, on NVIDIA GPUs. ``python -m slambench.run`` runs one cell
of ``BENCHMARK.json`` once; ``slambench/reference`` is the plain PyTorch
reference that decides whether a run is correct."""
