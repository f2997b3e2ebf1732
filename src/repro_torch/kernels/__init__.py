"""The port's kernels: CUDA C++ sources in ``csrc/``, their Python
wrappers, the plain PyTorch versions (``ref.py``) and the device dispatch
(``ops.py``).  Importing this package builds nothing."""
