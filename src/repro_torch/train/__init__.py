"""Losses and the train step: the port of ``repro.train``."""
from repro_torch.train.loss import lm_loss, softmax_xent  # noqa: F401
from repro_torch.train.step import batch_to, make_train_step  # noqa: F401
