"""Multi-process parallelism: meshes, the launch, the data-parallel train
step, the GSPMD-style (FSDP2 / DTensor) step, expert and pipeline
parallelism."""
from .dp import make_dp_train_step, shard_batch  # noqa: F401
from .gspmd import batch_spec, make_gspmd_train_step, param_spec, shard_params  # noqa: F401
from .launch import maybe_initialize_distributed  # noqa: F401
from .mesh import P, data_sharding, make_mesh, replicated  # noqa: F401
from .pp import pipeline_apply, shard_stacked_params, stack_layer_params  # noqa: F401
