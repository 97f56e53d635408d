"""The exchange's wire format (``codec``) and its fabric
(``collectives``: the process-group calls, the ``xla`` and ``ring``
backends and their byte models): the port of ``repro.comm``."""
from repro_torch.comm.codec import (CODECS, EFWrapper,  # noqa: F401
                                    F32Codec, Int2Codec, Int4Codec,
                                    Int8Codec, TopKCodec, UpdateCodec,
                                    get_codec)
from repro_torch.comm.collectives import (BACKENDS,  # noqa: F401
                                          COLLECTIVE_BACKENDS,
                                          CollectiveBackend, Fabric,
                                          get_backend, padded_len,
                                          recording, wire_bytes)
