"""The kernels' plain PyTorch versions in one place (the port of
``repro.kernels.ref``), so that kernel tests and ``chip_smoke.py`` hold
each kernel against its plain version through one module.
"""
from repro_torch.core.solvers import scd_steps as scd_steps_ref  # noqa: F401
from repro_torch.core.solvers import soft_threshold  # noqa: F401
from repro_torch.kernels.dequant import (decode_reduce_int2_ref,
                                         decode_reduce_int4_ref,
                                         decode_reduce_int8_ref)
from repro_torch.kernels.quant import (quantize_pack_int2_ref,  # noqa: F401
                                       quantize_pack_int4_ref,
                                       quantize_pack_int8_ref)
from repro_torch.kernels.topk import topk_select_ref  # noqa: F401

_DECODE_REDUCE_REF = {"int8": decode_reduce_int8_ref,
                      "int4": decode_reduce_int4_ref,
                      "int2": decode_reduce_int2_ref}


def decode_stacked_ref(codec: str, parts, length: int, *, mean: bool = True):
    """Plain decode+reduce of a gathered ``(K, wire)`` payload of the
    ``int8``, ``int4`` or ``int2`` codec in worker order (mean = sum
    times the f32-rounded 1/K)."""
    if codec not in _DECODE_REDUCE_REF:
        raise ValueError(f"decode_stacked_ref({codec!r}): expected one of "
                         f"{tuple(_DECODE_REDUCE_REF)}")
    payload, scales = parts
    return _DECODE_REDUCE_REF[codec](payload, scales, length, mean=mean)
