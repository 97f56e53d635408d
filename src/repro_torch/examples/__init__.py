"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
``quickstart`` walks the paper's workload end to end, ``tune_h`` tunes
the H knob against measured rounds and a time model, ``train_lm`` trains
a ~100M-param LM and ``serve_lm`` serves the dense archs at
``.reduced()``. Each runs on the card unless given ``--device cpu``."""
