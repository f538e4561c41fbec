"""Hand-written CUDA kernels for Hopper (``csrc/``), their ctypes
wrappers, the plain torch versions beside them, and the dispatch in
``ops``. Kernels are built with nvcc on first use (``_build``)."""
