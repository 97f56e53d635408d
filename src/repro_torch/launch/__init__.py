"""Entry points: the port of ``repro.launch`` (``train``, ``serve``, and
the sharded driver's multi-process entry, ``dist``)."""
