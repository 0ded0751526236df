"""PyTorch/CUDA port of the Bento file-system reproduction.

Mirrors the layout of the JAX reference package ``repro`` (``core/``,
``fs/``, ``kernels/``) and imports nothing from it. Entry points take a
``device``; left unset they run on ``"cuda"`` and raise when no GPU is
present. Pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels on the host.
"""
