"""Data-parallel training, one process a card (port of gcl_tpu/parallel)."""
from .launch import (backend_for, build_kernels_once, data_parallel_ranks,
                     init_from_env, rank_device, run_ranks, spawn)
from .mesh import (broadcast_module, check_divisible, fold_in,
                   make_global_grad_fn, make_parallel_train_step, shard_of,
                   world)
