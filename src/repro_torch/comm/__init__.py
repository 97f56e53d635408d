"""The exchange's wire format (``codec``) and its byte model
(``collectives``): the port of ``repro.comm``."""
from repro_torch.comm.codec import (CODECS, F32Codec, Int8Codec,  # noqa: F401
                                    UpdateCodec, get_codec)
from repro_torch.comm.collectives import padded_len, wire_bytes  # noqa: F401
