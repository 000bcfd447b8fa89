"""PyTorch / CUDA port of the LW-FedSSL system for one NVIDIA H100.

The JAX package ``repro`` beside it is the reference; this package imports
nothing of it (and never ``jax``). Its entry points run on the card unless
the caller passes ``device="cpu"``; on the CPU every kernel is replaced by
its plain PyTorch version (``repro_torch.kernels.ref``).
"""
