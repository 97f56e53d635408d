"""The kernels' plain PyTorch versions in one place (the port of
``repro.kernels.ref``), so that kernel tests and ``chip_smoke.py`` hold
each kernel against its plain version through one module.
"""
from repro_torch.core.solvers import scd_steps as scd_steps_ref  # noqa: F401
from repro_torch.core.solvers import soft_threshold  # noqa: F401
from repro_torch.kernels.dequant import decode_reduce_int8_ref
from repro_torch.kernels.quant import quantize_pack_int8_ref  # noqa: F401


def decode_stacked_ref(codec: str, parts, length: int, *, mean: bool = True):
    """Plain decode+reduce of a gathered ``(K, wire)`` payload in worker
    order (mean = sum times the f32-rounded 1/K). Only ``int8`` is
    ported; int4 and int2 wait for their kernels (ROADMAP.md Queue 2)."""
    if codec != "int8":
        raise NotImplementedError(
            f"decode_stacked_ref({codec!r}): only int8 is ported; int4 and "
            f"int2 are ROADMAP.md Queue 1 item 5 and Queue 2")
    q, scales = parts
    return decode_reduce_int8_ref(q, scales, length, mean=mean)
