"""Problem construction and the compiled Program.

PyTorch counterpart of ``skeres_tpu/core/problem.py`` (reference lineage:
``internal/ceres/problem_impl.cc``, ``program.cc``). Parameters live in
typed arrays — one ``(num_blocks, block_size)`` array per *parameter
group* — and residual blocks are grouped into homogeneous *batches* that
evaluate as one vmapped program each.

A residual function is written for ONE residual block:

    fn(params: tuple[torch.Tensor, ...], data) -> torch.Tensor  # (m,)

``params`` holds one ambient vector per parameter slot and ``data`` the
block's constants (a tensor, a tuple of tensors, or None). The evaluator
maps it over a batch with ``torch.func.vmap`` and differentiates it in the
tangent space with ``torch.func.vjp``/``jvp``.

Problems are built in bulk (``add_parameter_block_array``,
``add_residual_blocks``: the bundle-adjustment path) or block by block
(``add_parameter_block``, ``add_residual_block``, whose ids tag rows, e.g.
for ``residual_blocks_for_subset_preconditioner``). Removing blocks,
constant blocks, bounds and numeric differentiation are still to port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from skeres_tpu_torch.models.manifolds import EuclideanManifold
from skeres_tpu_torch.ops.loss import LossFunction

__all__ = [
    "Problem",
    "ParameterBlock",
    "ParameterBlockArray",
    "ResidualBlockId",
    "Program",
    "CompiledBatch",
    "state_from_numpy",
]


@dataclasses.dataclass
class _Group:
    """One parameter group: a typed array of blocks sharing a manifold."""

    name: str
    size: int
    manifold: EuclideanManifold
    values: np.ndarray  # (n, size) float64 master copy (host)
    # 0 = eliminated by the Schur solvers (points), 1 = retained (cameras)
    schur_group: Optional[int] = None

    @property
    def tangent_size(self) -> int:
        return self.manifold.tangent_size

    @property
    def num_blocks(self) -> int:
        return self.values.shape[0]


class ParameterBlockArray:
    """Handle to one parameter group: values (n, size), one manifold."""

    def __init__(self, problem: "Problem", group_index: int):
        self._problem = problem
        self.group_index = group_index

    @property
    def _group(self) -> _Group:
        return self._problem._groups[self.group_index]

    @property
    def values(self) -> np.ndarray:
        return self._group.values

    @property
    def size(self) -> int:
        return self._group.size

    def __len__(self):
        return self._group.num_blocks


class ParameterBlock:
    """Handle to one parameter block: a row of a group's value array."""

    def __init__(self, problem: "Problem", group_index: int, row: int):
        self._problem = problem
        self.group_index = group_index
        self.row = row

    @property
    def value(self) -> np.ndarray:
        return self._problem._groups[self.group_index].values[self.row]

    @property
    def size(self) -> int:
        return self._problem._groups[self.group_index].size


class ResidualBlockId:
    """Opaque handle returned by ``add_residual_block`` (reference:
    ``Problem::ResidualBlockId``)."""

    __slots__ = ("_rid",)

    def __init__(self, rid: int):
        self._rid = rid

    def __repr__(self):
        return f"ResidualBlockId({self._rid})"


@dataclasses.dataclass
class CompiledBatch:
    """One homogeneous residual batch, frozen for the evaluator."""

    fn: Callable
    loss: Optional[LossFunction]
    slot_groups: Tuple[int, ...]
    slot_indices: Tuple[np.ndarray, ...]  # per slot (B,) int64
    data: Any  # numpy array / tuple of arrays, leading axis B, or None
    num_blocks: int
    residual_dim: int
    tangent_sizes: Tuple[int, ...]  # per slot
    block_tangent_size: int  # sum of tangent sizes
    tangent_index: np.ndarray  # (B, T) global tangent index per local coord
    name: str = ""
    # per row the id handed out by add_residual_block (None for a bulk batch):
    # maps user-tagged residual blocks to rows
    row_ids: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass
class Program:
    """The frozen problem: counterpart of the reference's reduced Program."""

    groups: List[_Group]
    batches: List[CompiledBatch]
    tangent_offset: List[int]  # per group, offset of block 0's tangent span
    num_tangent: int  # N: total tangent dimension
    num_parameters: int
    num_effective_parameters: int
    num_parameter_blocks: int
    num_residual_blocks: int
    num_residuals: int

    def initial_state(self, device, dtype) -> tuple:
        """The state: one (n, size) tensor per group, on ``device``."""
        return state_from_numpy(self, [g.values for g in self.groups], device, dtype)

    def write_back(self, state) -> None:
        """Copy the state back into the host-side master values."""
        for g, arr in zip(self.groups, state):
            g.values = arr.detach().to("cpu", torch.float64).numpy().copy()


def state_from_numpy(program: Program, arrays, device, dtype) -> tuple:
    """Turn per-group numpy values (e.g. ``np.asarray(v)`` for each group of
    the JAX package's ``program.initial_state(...)``) into the port's
    state, checking each shape against the program's groups."""
    if len(arrays) != len(program.groups):
        raise ValueError(
            f"{len(arrays)} arrays for {len(program.groups)} parameter groups"
        )
    state = []
    for g, a in zip(program.groups, arrays):
        a = np.asarray(a, dtype=np.float64)
        if a.shape != g.values.shape:
            raise ValueError(
                f"group {g.name}: shape {a.shape} != {g.values.shape}"
            )
        state.append(torch.tensor(a, dtype=dtype, device=device))
    return tuple(state)


class Problem:
    """User-facing problem registry (reference: ``include/ceres/problem.h``)."""

    def __init__(self):
        self._groups: List[_Group] = []
        self._batches: List[dict] = []  # bulk batches and per-block ones, in order
        self._block_batches: dict = {}  # (fn, loss, slot groups, name) -> per-block batch
        self._num_residual_blocks = 0
        self._next_residual_id = 0

    def add_parameter_block_array(
        self, values, manifold=None, name: Optional[str] = None
    ) -> ParameterBlockArray:
        """Register n homogeneous parameter blocks at once."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64)).copy()
        n, size = values.shape
        if manifold is None:
            manifold = EuclideanManifold(size)
        elif not isinstance(manifold, EuclideanManifold):
            raise NotImplementedError(
                f"{type(manifold).__name__}: only EuclideanManifold is ported"
            )
        if manifold.ambient_size != size:
            raise ValueError(
                f"manifold ambient size {manifold.ambient_size} != block size {size}"
            )
        self._groups.append(
            _Group(name=name or f"group{len(self._groups)}", size=size,
                   manifold=manifold, values=values)
        )
        return ParameterBlockArray(self, len(self._groups) - 1)

    def add_parameter_block(self, values) -> ParameterBlock:
        """Register a single parameter block. Blocks of one size coalesce
        into one group, so that they batch together."""
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        size = values.shape[0]
        for gi, g in enumerate(self._groups):
            if g.size == size and g.name.startswith("_scalar"):
                g.values = np.concatenate([g.values, values[None]], axis=0)
                return ParameterBlock(self, gi, g.num_blocks - 1)
        self._groups.append(
            _Group(name=f"_scalar{len(self._groups)}_s{size}", size=size,
                   manifold=EuclideanManifold(size), values=values[None].copy())
        )
        return ParameterBlock(self, len(self._groups) - 1, 0)

    def set_schur_elimination_group(self, arr: ParameterBlockArray, group: int):
        """Declare Schur structure: 0 = eliminated (points), 1 = retained
        (cameras). Counterpart of ParameterBlockOrdering groups 0/1."""
        arr._group.schur_group = int(group)

    def add_residual_block(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        params: Sequence[ParameterBlock],
        data: Any = None,
        name: str = "",
    ) -> ResidualBlockId:
        """Add one residual block. Blocks with the same (fn, loss, group
        signature) batch together at compile time."""
        slot_groups = tuple(p.group_index for p in params)
        key = (id(fn), id(loss), slot_groups, name)
        spec = self._block_batches.get(key)
        if spec is None:
            spec = dict(fn=fn, loss=loss, slot_groups=slot_groups,
                        slot_indices=[[] for _ in params], data_rows=[], num_blocks=0,
                        name=name or getattr(fn, "__name__", "residual"), row_ids=[])
            self._block_batches[key] = spec
            self._batches.append(spec)
        for slot, p in enumerate(params):
            spec["slot_indices"][slot].append(p.row)
        spec["data_rows"].append(data)
        spec["num_blocks"] += 1
        spec["row_ids"].append(self._next_residual_id)
        self._num_residual_blocks += 1
        self._next_residual_id += 1
        return ResidualBlockId(spec["row_ids"][-1])

    def add_residual_blocks(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        params: Sequence[Tuple[ParameterBlockArray, Any]],
        data: Any = None,
        num_blocks: Optional[int] = None,
        name: str = "",
        numeric_diff: bool = False,
    ) -> None:
        """Bulk-add B homogeneous residual blocks.

        Args:
          params: per slot, ``(array_handle, indices)`` where indices is a
            (B,) int array selecting the block for each residual, or an
            ``array_handle`` alone / ``(handle, None)`` meaning block b
            uses row b.
          data: array or tuple of arrays stacked along axis 0 with length B.
        """
        if numeric_diff:
            raise NotImplementedError("numeric_diff is not ported yet")
        norm = [(p, None) if isinstance(p, ParameterBlockArray) else (p[0], p[1])
                for p in params]
        sizes = {len(np.asarray(idx)) for _, idx in norm if idx is not None}
        leaves = [] if data is None else pytree.tree_leaves(data)
        if leaves:
            sizes.add(int(np.asarray(leaves[0]).shape[0]))
        if num_blocks is not None:
            sizes.add(int(num_blocks))
        if not sizes:
            sizes = {len(norm[0][0])}
        if len(sizes) != 1:
            raise ValueError(f"inconsistent batch sizes: {sizes}")
        B = sizes.pop()
        self._batches.append(
            dict(
                fn=fn,
                loss=loss,
                slot_groups=tuple(arr.group_index for arr, _ in norm),
                slot_indices=[
                    np.arange(B, dtype=np.int64) if idx is None
                    else np.asarray(idx, dtype=np.int64)
                    for _, idx in norm
                ],
                data=None if data is None else pytree.tree_map(np.asarray, data),
                num_blocks=B,
                name=name or getattr(fn, "__name__", "residual"),
            )
        )
        self._num_residual_blocks += B

    def _infer_residual_dim(self, spec) -> int:
        xs = tuple(
            torch.as_tensor(self._groups[gi].values[0]) for gi in spec["slot_groups"]
        )
        example = None if spec["data"] is None else pytree.tree_map(
            lambda a: torch.as_tensor(a[0]), spec["data"])
        shape = tuple(spec["fn"](xs, example).shape)
        if len(shape) != 1:
            raise ValueError(
                f"residual fn {spec['name']} must return a rank-1 tensor, got {shape}"
            )
        return shape[0]

    def compile(self) -> Program:
        """Freeze into a Program: stack batches, assign tangent offsets."""
        groups = self._groups
        tangent_offset: List[int] = []
        off = 0
        for g in groups:
            tangent_offset.append(off)
            off += g.num_blocks * g.tangent_size

        batches: List[CompiledBatch] = []
        for spec in self._batches:
            if "data_rows" in spec:  # added block by block: stack the rows
                rows = spec["data_rows"]
                spec = dict(
                    spec,
                    slot_indices=[np.asarray(ix, dtype=np.int64) for ix in spec["slot_indices"]],
                    data=None if rows[0] is None else pytree.tree_map(
                        lambda *r: np.stack([np.asarray(v) for v in r]), *rows),
                )
            B = spec["num_blocks"]
            tangent_sizes = tuple(groups[gi].tangent_size for gi in spec["slot_groups"])
            t_block = sum(tangent_sizes)
            tangent_index = np.zeros((B, t_block), dtype=np.int64)
            col = 0
            for slot, gi in enumerate(spec["slot_groups"]):
                t = tangent_sizes[slot]
                base = tangent_offset[gi] + spec["slot_indices"][slot] * t
                tangent_index[:, col : col + t] = base[:, None] + np.arange(t)[None, :]
                col += t
            batches.append(
                CompiledBatch(
                    fn=spec["fn"],
                    loss=spec["loss"],
                    slot_groups=spec["slot_groups"],
                    slot_indices=tuple(spec["slot_indices"]),
                    data=spec["data"],
                    num_blocks=B,
                    residual_dim=self._infer_residual_dim(spec),
                    tangent_sizes=tangent_sizes,
                    block_tangent_size=t_block,
                    tangent_index=tangent_index,
                    name=spec["name"],
                    row_ids=tuple(spec["row_ids"]) if "row_ids" in spec else None,
                )
            )

        return Program(
            groups=groups,
            batches=batches,
            tangent_offset=tangent_offset,
            num_tangent=off,
            num_parameters=sum(g.num_blocks * g.size for g in groups),
            num_effective_parameters=off,
            num_parameter_blocks=sum(g.num_blocks for g in groups),
            num_residual_blocks=self._num_residual_blocks,
            num_residuals=sum(b.num_blocks * b.residual_dim for b in batches),
        )
