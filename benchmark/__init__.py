"""The benchmark of the PyTorch and CUDA port (``hmsr_tpu_torch``): its
harness, traffic generator, plain reference and per-layer readers. The
command is ``python3 benchmark/run.py``; ``BENCHMARK.json`` at the root
lists the cells."""
