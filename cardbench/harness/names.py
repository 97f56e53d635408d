"""The program's kernel names as a device trace shows them (the CUDA
functions of ``src/repro_torch/kernels/csrc``), one matcher a kernel."""
import re

_K1 = re.compile(r"(?<![A-Za-z0-9_])scd_kernel")
_K2 = re.compile(r"(?<![A-Za-z0-9_])quant_(kernel|grid_[a-z]+)")
_K3 = re.compile(r"(?<![A-Za-z0-9_])dequant_kernel")


def k1(name: str) -> bool:
    """K1, the local SCD solve (every form)."""
    return bool(_K1.search(name))


def k2(name: str) -> bool:
    """K2, the quantize-and-pack encode (cluster and grid forms)."""
    return bool(_K2.search(name))


def k3(name: str) -> bool:
    """K3, the decode and reduce."""
    return bool(_K3.search(name))
