"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version; built from `csrc/` at first use (`_build.py`)."""
