"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (see ``build.py`` for how they are compiled and loaded)."""
