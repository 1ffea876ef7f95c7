"""PyTorch/CUDA port of the stratified-LSH system (``repro``'s counterpart).

The package mirrors ``repro``'s module and function names so each
counterpart is easy to find, and imports neither ``jax`` nor ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve`); the ``"cuda"``
backend runs the hand-written Hopper kernels under ``csrc/``, the
``"torch"`` backend the plain staged path that serves as the port's oracle.
"""
