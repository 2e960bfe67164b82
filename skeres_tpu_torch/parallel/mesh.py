"""The ``obs`` mesh: residual rows sharded over ranks of torch.distributed.

PyTorch counterpart of ``skeres_tpu/parallel/mesh.py``. The JAX package
runs one SPMD program over ``jax.sharding.Mesh(devices, ("obs",))`` and
lets XLA insert the ``psum``s; here every rank is a process of its own,
and the port states each reduction itself. The design:

- **The mesh.** A 1-D ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names=("obs",)``, one rank per device, PyTorch's own
  counterpart of ``Mesh(devices, ("obs",))`` (:func:`make_obs_mesh`).
  Several ranks may share one card under gloo (NCCL refuses two ranks on
  one GPU): that certifies the sharded code paths, not a multi-GPU rate.
- **What each rank holds.** Every rank builds the whole ``Problem`` on the
  host, as each JAX process does, and puts only its own contiguous range
  of observation rows on its device (``core/evaluator.py``). The parameter
  state is replicated: every rank applies the same steps to its own copy.
- **Reductions.** Every reduction over rows is local, then one
  ``all_reduce`` over the mesh's group (:func:`all_reduce_sum`), the
  counterpart of ``jax.lax.psum``. An ``all_reduce`` leaves the same bits
  on every rank (gloo and NCCL both finish a ring with the reduced chunks
  broadcast), so every rank takes the same decisions from the same
  reduced values, and everything computed from replicated values (S, its
  factor by K1 / K2, the step) is the same on every rank too.
- **Shard boundaries.** They follow the JAX convention exactly, so that
  the straddle sets of the sharded explicit S agree: ``B`` rows padded to
  a multiple of the shard count ``ns`` give ``bs = ceil(B / ns)``, and
  shard ``s`` owns rows ``[s bs, min((s + 1) bs, B))``
  (``skeres_tpu/core/evaluator.py:123-128``,
  ``skeres_tpu/core/explicit_schur.py:480-483``). The JAX padding falls
  on the tail of the last shards; the port has no pad rows, so its last
  shards are simply shorter (:func:`shard_rows`).

Collectives under a CUDA-graph capture (the device loop) are NCCL's; a
gloo group cannot be captured, so ``use_device_loop`` with gloo on the
card raises (``core/device_loop.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

__all__ = [
    "all_reduce_sum",
    "check_obs_mesh",
    "default_backend",
    "initialize_distributed",
    "make_obs_mesh",
    "shard_rows",
]


def default_backend(device_type: str, world_size: int) -> str:
    """gloo on the CPU and for several ranks sharing a card; NCCL for one
    rank per card."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    device_type: str = "cuda",
) -> Tuple[int, int]:
    """``dist.init_process_group`` with the usual env fallbacks
    (``MASTER_ADDR``/``MASTER_PORT`` through ``env://``, ``WORLD_SIZE``,
    ``RANK``); call once per process before :func:`make_obs_mesh`. Does
    nothing when a group is already initialized. With no world size given
    or in the environment, a one-rank group on an in-memory store. Returns
    ``(rank, world_size)``."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    world_size = 1 if world_size is None else world_size
    if rank is None:
        if world_size > 1:
            raise ValueError("initialize_distributed: a world of several ranks needs each "
                             "process's rank (argument or RANK)")
        rank = 0
    backend = backend or default_backend(device_type, world_size)
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


def make_obs_mesh(num_devices: Optional[int] = None, device_type: str = "cuda"):
    """The 1-D ``("obs",)`` mesh over the first ``num_devices`` ranks (all
    of them by default). Every rank calls it; a world smaller than
    ``num_devices`` raises ``ValueError``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_obs_mesh: call initialize_distributed first")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, found {world}")
    return DeviceMesh(device_type, torch.arange(n), mesh_dim_names=("obs",))


def check_obs_mesh(mesh) -> None:
    """``TypeError`` unless ``mesh`` is a 1-D ``DeviceMesh`` holding this
    rank."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(
            f"SolverOptions.mesh takes a 1-D torch.distributed DeviceMesh "
            f"(parallel.make_obs_mesh), not {mesh!r}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not part of the mesh")


def shard_rows(n_rows: int, n_shards: int, shard: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of ``shard`` out of ``n_shards``: ``bs =
    ceil(n_rows / n_shards)`` rows a shard, the last shards shorter (or
    empty)."""
    bs = -(-n_rows // n_shards)
    return min(shard * bs, n_rows), min((shard + 1) * bs, n_rows)


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh's ranks, in place (the counterpart of
    ``jax.lax.psum``); returns ``t``. ``all_reduce_sum.calls`` and
    ``.bytes`` count what it was handed (under a CUDA-graph capture, the
    captures, not the replays)."""
    dist.all_reduce(t, group=mesh.get_group(0))
    all_reduce_sum.calls += 1
    all_reduce_sum.bytes += t.numel() * t.element_size()
    return t


all_reduce_sum.calls = 0
all_reduce_sum.bytes = 0
