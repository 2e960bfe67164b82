"""One sharded explicit-S LM step on ``n_ranks`` processes.

PyTorch counterpart of ``__graft_entry__.py:dryrun_multichip``: the JAX
entry's scene (200 cameras, 40,003 points, 5 observations a point; the odd
point count puts straddling points on the shard boundaries), its rows
sharded over a 1-D ``("obs",)`` mesh, and one full LM step through the
sharded explicit Schur complement: the sharded evaluation and reductions,
K3 on each rank's point grid and on the replicated straddle grid, the
replicated S factored by K2 (1,800 rows), the candidate's cost. Each rank
asserts that the plan is sharded, that some points straddle, and that the
cost falls.

``dryrun_multichip(n_ranks, device)`` spawns the ranks as processes of
this module (``python -m skeres_tpu_torch.parallel.dryrun --rank r ...``)
on a file store in a temporary directory. The backend is gloo on the CPU
and for several ranks sharing one card, NCCL for one rank a card
(``parallel.mesh.default_backend``). A rank that fails makes the call
raise.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

__all__ = ["dryrun_multichip", "run_ranks"]

SCENE = dict(num_cameras=200, num_points=40_003, observations_per_point=5)


def run_ranks(argv, n_ranks: int, timeout: float, env=None, cwd=None) -> list:
    """Start ``argv(store, r)`` for every rank r at once (``store``: a file
    in a fresh temporary directory, for ``init_method="file://..."``),
    wait for all, and return their standard outputs in rank order. A rank
    that fails stops the others (they would wait in a collective) and
    makes the call raise with its standard error, as does a run past
    ``timeout`` seconds."""
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        files = [(open(os.path.join(tmp, f"out{r}"), "w+"), open(os.path.join(tmp, f"err{r}"), "w+"))
                 for r in range(n_ranks)]
        procs = [subprocess.Popen(argv(store, r), stdout=o, stderr=e, text=True, env=env, cwd=cwd)
                 for r, (o, e) in enumerate(files)]
        t0 = time.time()
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) or time.time() - t0 > timeout:
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        outs = []
        for o, e in files:
            o.seek(0)
            e.seek(0)
            outs.append((o.read(), e.read()))
            o.close()
            e.close()
    failed = [(r, p.returncode, err[-3000:]) for r, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"{n_ranks} ranks of {argv(store, 0)[:4]}: failed (rank, exit code, "
                           f"standard error): {failed}")
    return [out for out, _ in outs]


def dryrun_multichip(n_ranks: int, device: str = "cpu", dtype: str = "float64",
                     timeout: float = 900.0) -> list:
    """Run the step on ``n_ranks`` processes; returns each rank's report
    (a dict: cost before and after, ``n_straddle``, its rows, its kernel
    and collective counts), in rank order."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    outs = run_ranks(lambda store, r: [
        sys.executable, "-m", "skeres_tpu_torch.parallel.dryrun", "--rank", str(r), "--world",
        str(n_ranks), "--store", store, "--device", device, "--dtype", dtype],
        n_ranks, timeout, env=env, cwd=root)
    return [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]) for out in outs]


def _rank_main(rank: int, world: int, store: str, device: str, dtype_name: str) -> dict:
    from skeres_tpu_torch.core.minimizer import TrustRegionMinimizer
    from skeres_tpu_torch.core.evaluator import Evaluator
    from skeres_tpu_torch.core.options import SolverOptions
    from skeres_tpu_torch.core.schur import SchurSolver
    from skeres_tpu_torch.core.summary import Summary
    from skeres_tpu_torch.core.types import LinearSolverType
    from skeres_tpu_torch.io.bal import build_bal_problem, synthetic_bal
    from skeres_tpu_torch.ops.cholesky import cholesky_both, trailing_update_
    from skeres_tpu_torch.ops.pair_product import pair_products
    from skeres_tpu_torch.parallel.mesh import (
        all_reduce_sum,
        initialize_distributed,
        make_obs_mesh,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_distributed(f"file://{store}", world, rank, device_type=dev.type)
    mesh = make_obs_mesh(device_type=dev.type)
    dtype = getattr(torch, dtype_name)

    problem, _, _ = build_bal_problem(synthetic_bal(**SCENE))
    program = problem.compile()
    ev = Evaluator(program, dev, dtype, mesh=mesh)
    state = program.initial_state(dev, dtype)
    options = SolverOptions(linear_solver_type=LinearSolverType.DENSE_SCHUR,
                            max_num_iterations=1, device=dev, dtype=dtype, mesh=mesh)
    schur = SchurSolver(ev, iterative=False)
    plan = schur.explicit_plan
    assert plan is not None, f"explicit-S plan not built: {schur.explicit_reject_reason}"
    assert plan.mesh is not None, "explicit-S plan not sharded"
    assert plan.n_straddle > 0, "no straddling point on the shard boundaries"
    minimizer = TrustRegionMinimizer(ev, options, Summary(), LinearSolverType.DENSE_SCHUR,
                                     schur_solver=schur)
    k1, up, k3 = cholesky_both.launches, trailing_update_.launches, pair_products.launches
    calls = all_reduce_sum.calls
    cost, g, diag, data, scale, _, _ = minimizer.linearize(state)
    jitter = torch.zeros((), dtype=dtype, device=dev)
    new_state = minimizer.solve_step(state, data, g, diag, scale, 1e4, jitter)[0]
    new_cost, _ = minimizer.try_step(new_state)
    cost, new_cost = float(cost), float(new_cost)
    assert torch.isfinite(torch.tensor([cost, new_cost])).all(), (cost, new_cost)
    assert new_cost < cost, f"LM step did not decrease cost: {cost} -> {new_cost}"
    return dict(rank=rank, world=world, cost=cost, new_cost=new_cost,
                n_straddle=plan.n_straddle, rows=list(ev.row_range[0]),
                points=int(plan.local_pt.numel()), s_rows=schur.num_f,
                k1_launches=cholesky_both.launches - k1,
                k2_update_launches=trailing_update_.launches - up,
                k3_launches=pair_products.launches - k3, k3_fixup_launches=plan.fix_products,
                all_reduces=all_reduce_sum.calls - calls, path=schur.schur_path)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--dtype", default="float64")
    a = ap.parse_args()
    torch.set_num_threads(1 if a.device == "cpu" else torch.get_num_threads())
    report = _rank_main(a.rank, a.world, a.store, a.device, a.dtype)
    print(json.dumps(report), flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
