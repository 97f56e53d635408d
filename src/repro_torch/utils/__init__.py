from repro_torch.utils.device import (full_f32_matmul, on_cuda,  # noqa: F401
                                      resolve_device)
