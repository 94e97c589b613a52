"""GSP-Louvain in PyTorch, with hand-written CUDA kernels for Hopper.

A port of :mod:`repro` (the JAX package) that mirrors its layout and names:
``graph/`` (padded directed-COO container, generators), ``kernels/`` (the
segment-reduction kernel and its plain PyTorch version) and ``core/`` (the
GSP-Louvain phases and the ``detect`` entry point), with the service
around them and the non-paper model scaffold (``models/``, ``optim/``,
``configs/``, ``launch/train.py``, ``launch/serve.py``).

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
CPU tensor every kernel wrapper takes its plain PyTorch version, on a CUDA
tensor it launches the kernel or raises.  The package imports neither jax
nor anything of :mod:`repro`.
"""
