"""Hand-written CUDA kernels for Hopper, each with its plain PyTorch version.

``ops`` is the entry point the models call; ``build`` compiles
``csrc/*.cu`` with nvcc at first use.
"""
