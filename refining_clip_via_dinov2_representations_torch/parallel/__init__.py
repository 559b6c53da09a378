"""Data parallelism over ``torch.distributed``: the mesh, the placement rule
of ZeRO-1 and FSDP, and the wrappers of the train step's module."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ParamSharding,
    apply_fsdp,
    create_mesh,
    data_shard_dim,
    full_state_dict,
    grad_sync_paused,
    load_full_state_dict,
    on_rank_rows,
    wrap_ddp,
    zero1_sharding,
)
