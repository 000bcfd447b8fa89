"""Hand-written Hopper kernels (``csrc/*.cu``), their ctypes bindings, the
plain PyTorch versions (``ref``) and the dispatching wrappers (``ops``)."""
