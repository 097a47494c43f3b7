"""Hand-written CUDA kernels for Hopper, their launch wrappers and their
plain PyTorch versions (see :mod:`repro_torch.kernels.ops`)."""
