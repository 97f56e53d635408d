"""Start the sharded driver's processes: the port of ``repro.launch``
(its multi-process entry, ``dist``)."""
