"""Multi-device solves over torch.distributed: the ``obs`` mesh
(``parallel/mesh.py``) and a multi-process dry run of one sharded LM step
(``parallel/dryrun.py``)."""

from skeres_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    check_obs_mesh,
    default_backend,
    initialize_distributed,
    make_obs_mesh,
    shard_rows,
)

__all__ = [
    "all_reduce_sum",
    "check_obs_mesh",
    "default_backend",
    "initialize_distributed",
    "make_obs_mesh",
    "shard_rows",
]
