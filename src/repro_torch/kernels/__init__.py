"""The port's kernels: hand-written CUDA C++ for Hopper under ``csrc/``,
each with a PyTorch wrapper, its plain version and a launch count."""
