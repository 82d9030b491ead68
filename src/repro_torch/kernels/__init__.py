"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  Sources live in `csrc/`; `build` compiles and loads them."""
