"""Checks on what the sharded driver moved, read from the recorded
collective log (the port of ``repro.analysis``, its traffic rules)."""
