"""PyTorch / CUDA port of the ``repro`` package, for one NVIDIA H100.

Same layout and names as the JAX package (``core/``, ``core/darknet/``,
``kernels/``, ``configs/``, ``models/``, ``serve/``, ``train/``, ``data/``,
``checkpoint/``, ``launch/``), so each module's counterpart is where a
reader looks for it.  The port imports
torch and numpy, never jax and nothing of ``repro``.  Its entry points run
on the card unless the caller asks for the CPU.
"""
