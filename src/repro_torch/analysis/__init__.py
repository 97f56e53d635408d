"""Checks on what the sharded drivers moved, read from the recorded
collective log (the port of ``repro.analysis``): ``traffic`` derives a
round's bytes from its calls, ``findings`` holds the typed rule
registry, ``rules`` populates it, ``cells`` defines the analyzable
matrix and runs it on a process group, and ``run`` is the ``python -m
repro_torch.analysis`` CLI. The reference's HLO tools (``graph``,
``pylint_jax``) have no counterpart: the log replaces the compiled
graph."""
