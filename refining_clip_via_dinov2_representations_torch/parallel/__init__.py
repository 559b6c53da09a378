"""Parallelism over ``torch.distributed``: the ``(data, model)`` mesh, the
placement rule of ZeRO-1 and FSDP, the wrappers of the train step's module,
and tensor parallelism over the model axis (``tensor.py``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    ParamSharding,
    apply_fsdp,
    axis_group,
    create_mesh,
    data_shard_dim,
    full_state_dict,
    grad_sync_paused,
    load_full_state_dict,
    on_rank_rows,
    tp_sharding,
    wrap_ddp,
    zero1_sharding,
)
from .tensor import ModelParallel, Split, model_parallel, param_split, shard_module
