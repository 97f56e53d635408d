"""AdamW, schedules and the local-update rounds: the port of
``repro.optim``."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, global_norm)
from repro_torch.optim.local_updates import (  # noqa: F401
    LocalUpdatesConfig, delta_wire_bytes, exchange_leaf,
    init_delta_codec_state, local_updates_round, suggest_H, virtual_round)
from repro_torch.optim.schedules import cosine_schedule  # noqa: F401
