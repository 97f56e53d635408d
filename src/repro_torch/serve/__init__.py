"""Serving: the port of ``repro.serve``."""
from repro_torch.serve.decode import greedy_generate, make_serve_step  # noqa: F401
