"""Losses and the train step: the port of ``repro.train``."""
from repro_torch.train.loss import lm_loss, softmax_xent  # noqa: F401
from repro_torch.train.step import (batch_to, loss_and_grads,  # noqa: F401
                                   make_train_step)
