# The paper's compute hot spot is the local SCD solver (K1, scd.py); the
# compressed exchange's two wire sides are the int8/int4/int2 quantize
# (K2, quant.py) and decode+reduce (K3, dequant.py), and the topk codec's
# select is K4 (topk.py). Each is CUDA C++ under csrc/, built at first use
# by _build.py, with its plain PyTorch version beside it; ref.py gathers
# the plain versions.
from repro_torch.kernels.dequant import (decode_mean_int2,  # noqa: F401
                                         decode_mean_int4, decode_mean_int8,
                                         decode_reduce_int2,
                                         decode_reduce_int4,
                                         decode_reduce_int8)
from repro_torch.kernels.ops import scd_steps_kernel  # noqa: F401
from repro_torch.kernels.quant import (quantize_pack_int2,  # noqa: F401
                                       quantize_pack_int4,
                                       quantize_pack_int8)
from repro_torch.kernels.ref import (decode_stacked_ref,  # noqa: F401
                                     quantize_pack_int2_ref,
                                     quantize_pack_int4_ref,
                                     quantize_pack_int8_ref, scd_steps_ref,
                                     topk_select_ref)
from repro_torch.kernels.scd import scd_solve  # noqa: F401
from repro_torch.kernels.topk import topk_select  # noqa: F401
