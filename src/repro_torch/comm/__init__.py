"""The exchange's wire format (``codec``) and its byte model
(``collectives``): the port of ``repro.comm``."""
from repro_torch.comm.codec import (CODECS, EFWrapper,  # noqa: F401
                                    F32Codec, Int2Codec, Int4Codec,
                                    Int8Codec, TopKCodec, UpdateCodec,
                                    get_codec)
from repro_torch.comm.collectives import padded_len, wire_bytes  # noqa: F401
