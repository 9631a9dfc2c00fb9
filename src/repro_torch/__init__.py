"""PyTorch/CUDA port of the SmartConf reproduction for NVIDIA Hopper.

Mirrors the reference package's layout (``configs``, ``core``, ``kernels``,
``models``, ``serve``, ``launch``).  Entry points run on CUDA unless the
caller passes ``device="cpu"``; on the CPU every kernel's plain PyTorch
version runs instead.  Importing this package builds nothing: kernels are
compiled with nvcc at first launch.
"""
