"""Device resolution: the port's counterpart of ``repro.utils.compat``'s
``on_tpu`` switch.

Entry points take an explicit ``device``. ``None`` means the card: with
no CUDA device that raises instead of carrying on on the CPU, so a run
that was meant for the card can never quietly measure the host. The
CPU is reached only by asking for it (``device="cpu"``), as the tests
do.
"""
from __future__ import annotations

import torch


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises ``RuntimeError`` when CUDA is asked for (or
    defaulted to) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch "
            "versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_cuda() -> bool:
    """Whether a CUDA card is present — the counterpart of the
    reference's ``compat.on_tpu()``. The kernel wrappers do not consult
    it: they dispatch on the device of the tensor they are given."""
    return torch.cuda.is_available()


def full_f32_matmul() -> None:
    """Keep matrix products' sums in full float32 on the card.

    TF32 keeps about three decimal digits, far too few for ``p_star`` and
    the primal metric, which are compared with the reference at rtol
    1e-5. And a bf16 product (the transformer's weights) may let cuBLAS
    reduce in bf16 (``allow_bf16_reduced_precision_reduction``, on by
    default): the reference accumulates its bf16 dots in f32, so the port
    turns that off. PyTorch's TF32 default is already off; both are set
    here explicitly because any caller in the process may have turned
    them on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
