"""fsptbench: the benchmark of fspt_tpu_torch, the PyTorch and CUDA path
tracer, on NVIDIA cards.  `python3 -m fsptbench --help`; BENCHMARK.json at
the checkout's root names its cells."""
