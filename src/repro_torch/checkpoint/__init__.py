"""Checkpoints in the reference's ``.npz`` layout: the port of
``repro.checkpoint``."""
from repro_torch.checkpoint.np_ckpt import (restore_checkpoint,  # noqa: F401
                                            save_checkpoint)
