"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version. Sources live in ``lightgbm_tpu_torch/csrc/``; ``build`` compiles
them with nvcc at first use."""
