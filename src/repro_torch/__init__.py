"""PyTorch + CUDA port of the SLO-aware serving system.

The package mirrors the JAX package ``repro`` module for module, so a
reader finds each counterpart under the same name.  It imports
``torch`` and nothing of ``jax`` or ``repro``: the framework-free
modules (``core``, ``configs``, ``engine.{blocks,prefix,request}``,
``data.synthetic``, ``models.config``) are copies of the reference.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`).  Every kernel wrapper in
:mod:`repro_torch.kernels.ops` picks its implementation by the device of
the tensors it is given: the plain PyTorch version for CPU tensors, the
hand-written CUDA kernel for CUDA tensors.  Nothing falls back.
"""
