"""One rank of the two-process gloo runs of tests/test_torch_port_parallel.py.

    python tests/torch_parallel_worker.py DIR RANK WORLD PORT

joins a gloo group at 127.0.0.1:PORT through the torchrun environment,
reads DIR/inputs.pt (written by the test) and runs, in order: the glue's
live collectives and a toy sharded gradient, one tiny stage-1 step (twice:
JAX's draws without dropout, and the port's with dropout) and one tiny
stage-2 step on this rank's rows, `run_stage1` over two epochs with its
saves recorded, its resume from a swap a crash interrupted, and the CLI's
`video --tiny` over stage-3 artifacts under DIR. Its results go to DIR/rank{RANK}.pt. Imports no JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def glue():
    from neurons_tpu_torch.parallel import distributed as D
    from neurons_tpu_torch.parallel.mesh import (create_mesh, replicate,
                                                 shard_batch)

    r = D.rank()
    D.barrier("glue")
    mesh = create_mesh("cpu")
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    w = torch.ones(4, requires_grad=True)
    xs = shard_batch(mesh, {"x": x})["x"]
    loss = torch.mean((xs @ w) ** 2)
    (w.grad,) = torch.autograd.grad(loss, [w])
    D.all_reduce_grads_([w])
    # a differentiable gather: d/dx_r of sum over the gathered rows of
    # c_i * row_i is c_r summed over both ranks' uses
    y = torch.full((2, 3), float(r + 1), requires_grad=True)
    g = D.gather_rows(y)
    coef = torch.arange(g.shape[0], dtype=torch.float32)[:, None]
    (gy,) = torch.autograd.grad((g * coef).sum(), [y])
    s = D.sum_across_ranks(torch.tensor(float(r + 1), requires_grad=True))
    rep = replicate(mesh, {"t": torch.full((3,), float(r))})
    return {"rank": r, "world": D.world_size(), "main": D.is_main_process(),
            "mesh": (mesh.world, mesh.rank),
            "broadcast": D.broadcast_from_host0({"a": np.arange(3) + r}),
            "allgather": D.process_allgather({"x": np.full((2, 3), r)}),
            "round_robin": D.round_robin_indices(10),
            "toy_grad": w.grad.clone(), "rows": xs.clone(),
            "gather": g.detach().clone(), "gather_grad": gy,
            "sum": float(s), "replicated": rep["t"]}


def stage_steps(inputs):
    from neurons_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from torch_parallel_steps import one_stage1_step, one_stage2_step

    mesh = create_mesh("cpu")
    out = {}
    for name in ("stage1", "stage1_dropout"):
        spec = inputs[name]
        out[name] = one_stage1_step(spec, shard_batch(mesh, spec["batch"]),
                                    mesh)
    spec = inputs["stage2"]
    out["stage2"] = one_stage2_step(spec, shard_batch(mesh, spec["batch"]),
                                    mesh)
    return out


def run_stage1_epoch(inputs, d):
    from neurons_tpu_torch.parallel.mesh import create_mesh
    from neurons_tpu_torch.training import loop
    from neurons_tpu_torch.utils import checkpoint as ckpt
    from torch_parallel_steps import record_saves, stage1_run_args

    calls = record_saves()
    ckpt.LAST_SAVE_STATS.clear()
    mesh = create_mesh("cpu")
    args, kw = stage1_run_args(inputs["run_stage1"])
    state = loop.run_stage1(*args, ckpt_dir=os.path.join(d, "ckpt"),
                            device="cpu", mesh=mesh, **kw)
    return {"calls": list(calls), "written": sorted(ckpt.LAST_SAVE_STATS),
            "params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            "step": state.step}


def resume_from_an_interrupted_swap(inputs, d):
    """A copy of `run_stage1_epoch`'s tags in which a crash between
    `save_ckpt`'s two renames left `brain_model_last.old` and no
    `brain_model_last`; both ranks resume from it for a third epoch."""
    import shutil

    from neurons_tpu_torch.parallel import distributed as D
    from neurons_tpu_torch.parallel.mesh import create_mesh
    from neurons_tpu_torch.training import loop
    from torch_parallel_steps import record_saves, stage1_run_args

    ckdir = os.path.join(d, "ckpt_resume")
    if D.is_main_process():
        shutil.copytree(os.path.join(d, "ckpt"), ckdir)
        last = os.path.join(ckdir, "brain_model_last")
        os.replace(last, last + ".old")
    D.barrier()
    spec = dict(inputs["run_stage1"],
                tcfg=dict(inputs["run_stage1"]["tcfg"], num_epochs=3))
    args, kw = stage1_run_args(spec)
    calls = record_saves()
    state = loop.run_stage1(*args, ckpt_dir=ckdir, device="cpu",
                            mesh=create_mesh("cpu"), resume=True, **kw)
    return {"calls": calls, "step": state.step,
            "params": {n: p.detach().clone()
                       for n, p in state.params.items()},
            "tags": sorted(os.listdir(ckdir))}


def video(d):
    from neurons_tpu_torch import cli
    cli.main(["video", "--tiny", "--synthetic", "--platform", "cpu",
              "--exp_dir", os.path.join(d, "EXP"),
              "--weights_dir", os.path.join(d, "w"),
              "--root_dir", os.path.join(d, "root")])
    return {"done": True}


def main():
    d, rank, world, port = sys.argv[1], *map(int, sys.argv[2:5])
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK="0")
    from neurons_tpu_torch.parallel import distributed
    if not distributed.initialize(backend="gloo"):
        raise SystemExit("initialize joined no group")
    inputs = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out = {"glue": glue(), "steps": stage_steps(inputs)}
    print(f"=== rank {rank}: run_stage1 ===", flush=True)
    out["run_stage1"] = run_stage1_epoch(inputs, d)
    print(f"=== rank {rank}: resume ===", flush=True)
    out["resume"] = resume_from_an_interrupted_swap(inputs, d)
    print(f"=== rank {rank}: video ===", flush=True)
    out["video"] = video(d)
    distributed.barrier()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))
    distributed.destroy()


if __name__ == "__main__":
    main()
