"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their plain
PyTorch versions (``ref``) and the wrappers that dispatch between them by
device (``ops``). Kernels are built and loaded at first launch
(``build``), never at import."""
