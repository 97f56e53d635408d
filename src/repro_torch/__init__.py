"""PyTorch/CUDA port of ``repro``: the paper's CoCoA round on an NVIDIA
H100, with the TPU's Pallas kernels rewritten by hand in CUDA C++ for
``sm_90a``.

The layout follows ``repro`` module for module (``core/``, ``comm/``,
``kernels/``, ``data/``, ``utils/``) so that each module's counterpart
is found by name. The port imports ``torch`` and numpy, never ``jax``
and nothing of ``repro``. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; with no card and no explicit ``"cpu"`` they
raise. A kernel wrapper handed a CPU tensor runs the kernel's plain
PyTorch version; handed a CUDA tensor it launches the kernel or raises.
"""
