"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version, routed by :mod:`repro_torch.kernels.dispatch`."""
