"""PyTorch/CUDA port of the CAMP quantized-serving stack.

A second package beside the JAX reference (``repro``), laid out module for
module like it, so that each port module pairs with its reference by path.
It imports ``torch`` and never ``jax`` or anything of ``repro``. Plain
PyTorch runs the host logic and every kernel's plain version; each Pallas
TPU kernel on the serving path is a hand-written CUDA C++ kernel for Hopper
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.
"""
