"""Problem construction and the compiled Program.

PyTorch counterpart of ``skeres_tpu/core/problem.py`` (reference lineage:
``internal/ceres/problem_impl.cc``, ``program.cc``). Parameters live in
typed arrays — one ``(num_blocks, block_size)`` array per *parameter
group* sharing one manifold — and residual blocks are grouped into
homogeneous *batches* that evaluate as one vmapped program each.

A residual function is written for ONE residual block:

    fn(params: tuple[torch.Tensor, ...], data) -> torch.Tensor  # (m,)

``params`` holds one ambient vector per parameter slot and ``data`` the
block's constants (a tensor, a tuple of tensors, or None). The evaluator
maps it over a batch with ``torch.func.vmap`` and differentiates
``fn(manifold.plus(x, delta))`` at ``delta = 0`` with ``torch.func``, or by
numeric differences where the batch asks for them (``numeric_diff``).

Problems are built in bulk (``add_parameter_block_array``,
``add_residual_blocks``: the bundle-adjustment path) or block by block
(``add_parameter_block``, ``add_residual_block``, whose ids tag rows and
can be removed). Blocks may be held constant (a 0/1 free mask over the
tangent space, ``Program.free_mask``, as in the JAX package: a constant
block keeps its columns, zeroed) and bounded (``Program.bounds_arrays``).
``Problem.evaluate`` evaluates the cost, residuals, gradient or Jacobian at
the current values.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from skeres_tpu_torch.models.manifolds import EuclideanManifold, Manifold
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
    manifold: Manifold
    values: np.ndarray  # (n, size) float64 master copy (host)
    constant: List[bool] = dataclasses.field(default_factory=list)
    lower: Optional[np.ndarray] = None  # (n, size) or None
    upper: Optional[np.ndarray] = None
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

    @values.setter
    def values(self, v):
        g = self._group
        v = np.asarray(v, dtype=np.float64)
        if v.shape != g.values.shape:
            raise ValueError(f"values of shape {v.shape} for a group of {g.values.shape}")
        g.values = v

    @property
    def size(self) -> int:
        return self._group.size

    def __len__(self):
        return self._group.num_blocks

    def __getitem__(self, i: int) -> "ParameterBlock":
        n = len(self)
        if not -n <= i < n:
            raise IndexError(i)
        return ParameterBlock(self._problem, self.group_index, i % n)


class ParameterBlock:
    """Handle to one parameter block: a row of a group's value array."""

    def __init__(self, problem: "Problem", group_index: int, row: int):
        self._problem = problem
        self.group_index = group_index
        self.row = row

    @property
    def _group(self) -> _Group:
        return self._problem._groups[self.group_index]

    @property
    def value(self) -> np.ndarray:
        return self._group.values[self.row]

    @value.setter
    def value(self, v):
        self._group.values[self.row] = np.asarray(v, dtype=np.float64)

    @property
    def size(self) -> int:
        return self._group.size

    @property
    def array(self) -> ParameterBlockArray:
        """The group this block belongs to, as an array handle."""
        return ParameterBlockArray(self._problem, self.group_index)


class ResidualBlockId:
    """Opaque handle returned by ``add_residual_block`` (reference:
    ``Problem::ResidualBlockId``); pass it to ``remove_residual_block``."""

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
    # differentiate by numeric differences in the tangent space instead of
    # torch.func (reference: NumericDiffCostFunction): "central",
    # "forward" or "ridders"
    numeric_diff: bool = False
    numeric_diff_step: float = 1e-6
    numeric_diff_method: str = "central"


@dataclasses.dataclass
class Program:
    """The frozen problem: counterpart of the reference's reduced Program."""

    groups: List[_Group]
    batches: List[CompiledBatch]
    tangent_offset: List[int]  # per group, offset of block 0's tangent span
    num_tangent: int  # N: total tangent dimension, constant blocks included
    free_mask: np.ndarray  # (N,) 1.0 free / 0.0 constant coordinate
    num_parameters: int
    num_effective_parameters: int
    num_parameter_blocks: int
    num_residual_blocks: int
    num_residuals: int
    num_parameters_reduced: int
    num_effective_parameters_reduced: int
    num_parameter_blocks_reduced: int
    has_bounds: bool

    def initial_state(self, device, dtype) -> tuple:
        """The state: one (n, size) tensor per group, on ``device``."""
        return state_from_numpy(self, [g.values for g in self.groups], device, dtype)

    def write_back(self, state) -> None:
        """Copy the state back into the host-side master values."""
        for g, arr in zip(self.groups, state):
            g.values = arr.detach().to("cpu", torch.float64).numpy().copy()

    def bounds_arrays(self, device, dtype):
        """Per-group (lower, upper) tensors, -inf / +inf where unset."""
        lowers, uppers = [], []
        for g in self.groups:
            lo = g.lower if g.lower is not None else np.full_like(g.values, -np.inf)
            hi = g.upper if g.upper is not None else np.full_like(g.values, np.inf)
            lowers.append(torch.tensor(lo, dtype=dtype, device=device))
            uppers.append(torch.tensor(hi, dtype=dtype, device=device))
        return tuple(lowers), tuple(uppers)


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


def _check_manifold(manifold, size: int) -> None:
    if manifold.ambient_size != size:
        raise ValueError(f"manifold ambient size {manifold.ambient_size} != block size {size}")


class Problem:
    """User-facing problem registry (reference: ``include/ceres/problem.h``)."""

    def __init__(self):
        self._groups: List[_Group] = []
        self._batches: List[dict] = []  # bulk batches and per-block ones, in order
        self._block_batches: dict = {}  # key -> per-block batch
        self._default_manifolds: dict = {}  # size -> the shared EuclideanManifold
        self._num_residual_blocks = 0
        self._next_residual_id = 0
        self._residual_registry: dict = {}  # residual id -> its per-block batch

    # -- parameter blocks -------------------------------------------------------

    def _default_manifold(self, size: int) -> Manifold:
        if size not in self._default_manifolds:
            self._default_manifolds[size] = EuclideanManifold(size)
        return self._default_manifolds[size]

    def add_parameter_block_array(
        self, values, manifold: Optional[Manifold] = None, name: Optional[str] = None
    ) -> ParameterBlockArray:
        """Register n homogeneous parameter blocks at once."""
        values = np.atleast_2d(np.asarray(values, dtype=np.float64)).copy()
        n, size = values.shape
        manifold = manifold or self._default_manifold(size)
        _check_manifold(manifold, size)
        self._groups.append(_Group(name=name or f"group{len(self._groups)}", size=size,
                                   manifold=manifold, values=values, constant=[False] * n))
        return ParameterBlockArray(self, len(self._groups) - 1)

    def add_parameter_block(self, values, manifold: Optional[Manifold] = None) -> ParameterBlock:
        """Register a single parameter block. Blocks of one size sharing
        one manifold object coalesce into one group, so that they batch
        together."""
        values = np.asarray(values, dtype=np.float64).reshape(-1)
        size = values.shape[0]
        manifold = manifold or self._default_manifold(size)
        _check_manifold(manifold, size)
        for gi, g in enumerate(self._groups):
            if g.size == size and g.manifold is manifold and g.name.startswith("_scalar"):
                g.values = np.concatenate([g.values, values[None]], axis=0)
                g.constant.append(False)
                for bound, fill in (("lower", -np.inf), ("upper", np.inf)):
                    if getattr(g, bound) is not None:
                        setattr(g, bound, np.concatenate(
                            [getattr(g, bound), np.full((1, size), fill)], axis=0))
                return ParameterBlock(self, gi, g.num_blocks - 1)
        self._groups.append(_Group(name=f"_scalar{len(self._groups)}_s{size}", size=size,
                                   manifold=manifold, values=values[None].copy(),
                                   constant=[False]))
        return ParameterBlock(self, len(self._groups) - 1, 0)

    def set_manifold(self, block_or_array, manifold: Manifold) -> None:
        """Set the manifold of a group (an array handle, or a block that is
        alone in its group)."""
        g = block_or_array._group
        if isinstance(block_or_array, ParameterBlock) and g.num_blocks > 1:
            raise ValueError(
                "cannot change the manifold of one block of a shared group; "
                "use add_parameter_block_array for per-array manifolds"
            )
        _check_manifold(manifold, g.size)
        g.manifold = manifold

    def set_parameter_block_constant(self, block: ParameterBlock) -> None:
        block._group.constant[block.row] = True

    def set_parameter_block_variable(self, block: ParameterBlock) -> None:
        block._group.constant[block.row] = False

    def set_parameter_block_array_constant(self, arr: ParameterBlockArray) -> None:
        arr._group.constant = [True] * arr._group.num_blocks

    def is_parameter_block_constant(self, block: ParameterBlock) -> bool:
        return block._group.constant[block.row]

    @staticmethod
    def _ensure_bounds(g: _Group) -> None:
        if g.lower is None:
            g.lower = np.full_like(g.values, -np.inf)
        if g.upper is None:
            g.upper = np.full_like(g.values, np.inf)

    def set_parameter_lower_bound(self, block: ParameterBlock, index: int, value: float) -> None:
        self._ensure_bounds(block._group)
        block._group.lower[block.row, index] = value

    def set_parameter_upper_bound(self, block: ParameterBlock, index: int, value: float) -> None:
        self._ensure_bounds(block._group)
        block._group.upper[block.row, index] = value

    def set_schur_elimination_group(self, arr: ParameterBlockArray, group: int):
        """Declare Schur structure: 0 = eliminated (points), 1 = retained
        (cameras). Counterpart of ParameterBlockOrdering groups 0/1."""
        arr._group.schur_group = int(group)

    # -- residual blocks ----------------------------------------------------------

    def add_residual_block(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        params: Sequence[ParameterBlock],
        data: Any = None,
        name: str = "",
        numeric_diff: bool = False,
        numeric_diff_relative_step_size: float = 1e-6,
        numeric_diff_method: str = "central",
    ) -> ResidualBlockId:
        """Add one residual block. Blocks with the same (fn, loss, group
        signature, name, numeric differentiation) batch together at compile
        time. ``numeric_diff=True`` differentiates the block by numeric
        differences in the tangent space (``numeric_diff_method``:
        "central", "forward" or "ridders") instead of ``torch.func``."""
        slot_groups = tuple(p.group_index for p in params)
        key = (id(fn), id(loss), slot_groups, name, numeric_diff, numeric_diff_method)
        spec = self._block_batches.get(key)
        if spec is None:
            spec = dict(fn=fn, loss=loss, slot_groups=slot_groups,
                        slot_indices=[[] for _ in params], data_rows=[], num_blocks=0,
                        name=name or getattr(fn, "__name__", "residual"), row_ids=[],
                        numeric_diff=numeric_diff,
                        numeric_diff_step=numeric_diff_relative_step_size,
                        numeric_diff_method=numeric_diff_method, key=key)
            self._block_batches[key] = spec
            self._batches.append(spec)
        for slot, p in enumerate(params):
            spec["slot_indices"][slot].append(p.row)
        spec["data_rows"].append(data)
        spec["num_blocks"] += 1
        rid = self._next_residual_id
        spec["row_ids"].append(rid)
        self._residual_registry[rid] = spec
        self._num_residual_blocks += 1
        self._next_residual_id += 1
        return ResidualBlockId(rid)

    def remove_residual_block(self, rbid: ResidualBlockId) -> None:
        """Remove one residual block added with ``add_residual_block``
        (reference: ``Problem::RemoveResidualBlock``). Bulk batches from
        ``add_residual_blocks`` are not individually removable."""
        spec = self._residual_registry.pop(rbid._rid, None)
        if spec is None:
            raise KeyError(f"unknown or already-removed residual block {rbid}")
        i = spec["row_ids"].index(rbid._rid)
        for slot_rows in spec["slot_indices"]:
            del slot_rows[i]
        del spec["data_rows"][i]
        del spec["row_ids"][i]
        spec["num_blocks"] -= 1
        self._num_residual_blocks -= 1
        if not spec["row_ids"]:
            self._batches = [s for s in self._batches if s is not spec]
            del self._block_batches[spec["key"]]

    def remove_parameter_block(self, block: ParameterBlock) -> None:
        """Remove a parameter block and every residual block that uses it
        (reference: ``Problem::RemoveParameterBlock``). As in the JAX
        package, the group's storage row stays (other handles stay valid),
        held constant and with no residual left on it."""
        gi, row = block.group_index, block.row
        doomed = []
        for spec in self._batches:
            refs = sorted({
                i
                for slot, g in enumerate(spec["slot_groups"]) if g == gi
                for i, r in enumerate(spec["slot_indices"][slot]) if r == row
            })
            if not refs:
                continue
            if "row_ids" not in spec:
                raise NotImplementedError(
                    "remove_parameter_block: block is referenced by a bulk "
                    "batch (add_residual_blocks); rebuild the problem instead"
                )
            doomed.extend(ResidualBlockId(spec["row_ids"][i]) for i in refs)
        for rbid in doomed:
            self.remove_residual_block(rbid)
        block._group.constant[row] = True

    def add_residual_blocks(
        self,
        fn: Callable,
        loss: Optional[LossFunction],
        params: Sequence[Tuple[ParameterBlockArray, Any]],
        data: Any = None,
        num_blocks: Optional[int] = None,
        name: str = "",
        numeric_diff: bool = False,
        numeric_diff_relative_step_size: float = 1e-6,
        numeric_diff_method: str = "central",
    ) -> None:
        """Bulk-add B homogeneous residual blocks.

        Args:
          params: per slot, ``(array_handle, indices)`` where indices is a
            (B,) int array selecting the block for each residual, or an
            ``array_handle`` alone / ``(handle, None)`` meaning block b
            uses row b.
          data: array or tuple of arrays stacked along axis 0 with length B.
          numeric_diff, numeric_diff_relative_step_size, numeric_diff_method:
            as for :meth:`add_residual_block`.
        """
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
                numeric_diff=numeric_diff,
                numeric_diff_step=numeric_diff_relative_step_size,
                numeric_diff_method=numeric_diff_method,
            )
        )
        self._num_residual_blocks += B

    # -- compile ------------------------------------------------------------------

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

        free_mask = np.ones((off,), dtype=np.float64)
        for g, o in zip(groups, tangent_offset):
            t = g.tangent_size
            for i, const in enumerate(g.constant):
                if const:
                    free_mask[o + i * t : o + (i + 1) * t] = 0.0

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
                    numeric_diff=spec["numeric_diff"],
                    numeric_diff_step=spec["numeric_diff_step"],
                    numeric_diff_method=spec["numeric_diff_method"],
                )
            )

        num_parameters = sum(g.num_blocks * g.size for g in groups)
        num_blocks = sum(g.num_blocks for g in groups)
        return Program(
            groups=groups,
            batches=batches,
            tangent_offset=tangent_offset,
            num_tangent=off,
            free_mask=free_mask,
            num_parameters=num_parameters,
            num_effective_parameters=off,
            num_parameter_blocks=num_blocks,
            num_residual_blocks=self._num_residual_blocks,
            num_residuals=sum(b.num_blocks * b.residual_dim for b in batches),
            num_parameters_reduced=num_parameters - sum(g.size * sum(g.constant) for g in groups),
            num_effective_parameters_reduced=off - sum(
                g.tangent_size * sum(g.constant) for g in groups),
            num_parameter_blocks_reduced=num_blocks - sum(sum(g.constant) for g in groups),
            has_bounds=any(g.lower is not None or g.upper is not None for g in groups),
        )

    def _subset_problem(self, residual_blocks) -> "Problem":
        """A shadow Problem sharing this one's parameter groups and holding
        only the given residual blocks (reference:
        ``EvaluateOptions::residual_blocks``)."""
        wanted = set()
        for rbid in residual_blocks:
            if rbid._rid not in self._residual_registry:
                raise KeyError(f"unknown or removed residual block {rbid}")
            wanted.add(rbid._rid)
        sub = Problem()
        sub._groups = self._groups  # shared parameter storage
        sub._default_manifolds = self._default_manifolds
        sub._next_residual_id = self._next_residual_id
        for spec in self._batches:
            if "row_ids" not in spec:
                continue  # bulk batches carry no ids
            rows = [i for i, r in enumerate(spec["row_ids"]) if r in wanted]
            if not rows:
                continue
            part = dict(spec, slot_indices=[[sl[i] for i in rows] for sl in spec["slot_indices"]],
                        data_rows=[spec["data_rows"][i] for i in rows],
                        row_ids=[spec["row_ids"][i] for i in rows], num_blocks=len(rows))
            sub._batches.append(part)
            sub._block_batches[part["key"]] = part
            for rid in part["row_ids"]:
                sub._residual_registry[rid] = part
            sub._num_residual_blocks += len(rows)
        return sub

    # -- evaluation (reference: Problem::Evaluate) ----------------------------------

    def evaluate(
        self,
        residuals: bool = False,
        gradient: bool = False,
        jacobian: bool = False,
        dtype=torch.float64,
        residual_blocks: Optional[Sequence[ResidualBlockId]] = None,
        apply_loss_function: bool = True,
        device="cuda",
    ):
        """Evaluate at the current parameter values, on ``device`` (the
        card unless the caller asks for the CPU); reference:
        ``Problem::Evaluate(EvaluateOptions, ...)``.

        Returns ``cost`` alone by default, else a dict with any of ``cost``
        (float), ``residuals`` ((M,) numpy, loss-corrected, batch order),
        ``gradient`` ((N_tangent,) = J^T r) and ``jacobian`` ((M, N_tangent)
        dense: small problems only). ``residual_blocks`` restricts the
        evaluation to those blocks (bulk batches have no ids);
        ``apply_loss_function=False`` evaluates without the robustifier."""
        from skeres_tpu_torch.core.evaluator import Evaluator

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"Problem.evaluate on {str(device)!r} but no CUDA device is available; "
                "pass device='cpu' to evaluate on the CPU"
            )
        target = self if residual_blocks is None else self._subset_problem(residual_blocks)
        program = target.compile()
        ev = Evaluator(program, device=device, dtype=dtype,
                       apply_loss_function=apply_loss_function)
        state = program.initial_state(device, dtype)
        if not (residuals or gradient or jacobian):
            return float(ev.cost(state))
        cost, blocks = ev.blocks(state)
        out = {"cost": float(cost)}
        host = lambda t: t.detach().to("cpu").numpy()  # noqa: E731
        if residuals or jacobian:
            jd, rd = ev.jacobian_dense(blocks)
            if residuals:
                out["residuals"] = host(rd)
            if jacobian:
                out["jacobian"] = host(jd)
        if gradient:
            out["gradient"] = host(ev.gradient_and_diag(blocks)[0])
        return out
