"""`neurons_tpu_torch.parallel` on the CPU: the single-process semantics of
the JAX package's glue (tests/test_mesh.py's), the mesh and the batch feed,
and two gloo processes (tests/torch_parallel_worker.py) against one.

The two-rank run (one pair of processes for the module, each with a
timeout, so a hang fails the test rather than the suite's limit) checks
the live barrier, broadcast and allgather, the toy sharded gradient equal
to the full one, one tiny stage-1 step and one tiny stage-2 step whose
averaged gradients equal the one-process gradient of the whole batch,
`run_stage1` over two epochs (rank 0 alone writes tags and metrics, both
ranks take the same decisions as one process), its resume from a swap a
crash interrupted, and the CLI's `video --tiny`, whose rank shards cover
the clips once.

Tolerances: gradients are compared by error norm, |g2 - g1| / |g1| over
every trainable tensor at once, <= 1e-5 in f32 (the ranks sum the loss
terms and the gradients in another order than one process); losses within
1e-6 relative of one process, equal bitwise across the ranks; the stage-1
loss within 1e-5 of the JAX package's step on the same global batch
(tests/test_torch_port_stage1.py's f32 rule). The
two-rank `run_stage1`'s epoch mean loss within 1e-4 of one process's (two
Adam updates), its parameters equal bitwise across the ranks.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.models.neurons import NeuronsCore as JCore
from neurons_tpu.parallel import distributed as JD
from neurons_tpu.training import train_brain as jtb
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.diffusion.prior import PriorDiffusion
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models.decoder_video import (RowSplit,
                                                    _SpatialTemporalAttn)
from neurons_tpu_torch.models.neurons import NeuronsCore
from neurons_tpu_torch.parallel import distributed as D
from neurons_tpu_torch.parallel import mesh as M
from neurons_tpu_torch.pipelines import io as tio
from neurons_tpu_torch.training import loop as tloop
from neurons_tpu_torch.training import losses as tlosses
from neurons_tpu_torch.training import train_brain as ttb
from neurons_tpu_torch.training import train_decoupler as td
from torch_parallel_steps import (B1, BCFG, one_stage1_step,
                                  one_stage2_step, record_saves,
                                  stage1_run_args, stage2_batch,
                                  stage2_configs)
from torch_port_utils import randomize, t

REPO = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_parallel_worker.py"
WORLD = 2
RANK_TIMEOUT_S = 120
STEP_KEY = jax.random.PRNGKey(9)
CLIPS = 4  # stage-3 clips of the two-rank `video` run


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(world=1, rank=0):
    return M.Mesh(world=world, rank=rank, device=torch.device("cpu"))


# ------------------------------------------- single-process semantics ----

def test_initialize_noop_without_env(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR", "RANK",
                "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert D.initialize() is False
    assert not torch.distributed.is_initialized()


def test_initialize_noop_world_size_one(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert D.initialize() is False
    assert not torch.distributed.is_initialized()


def test_single_process_barrier_and_broadcast():
    D.barrier("test")
    tree = {"a": np.arange(3)}
    out = D.broadcast_from_host0(tree)
    np.testing.assert_array_equal(out["a"], tree["a"])
    assert D.is_main_process()
    assert (D.world_size(), D.rank()) == (1, 0)


def test_process_allgather_adds_axis():
    out = D.process_allgather({"x": np.ones((2, 3)),
                               "t": torch.zeros(4)})
    assert out["x"].shape == (1, 2, 3) and out["t"].shape == (1, 4)


@pytest.mark.parametrize("total,shard,num", [(10, 1, 4), (7, 0, 3),
                                              (5, 2, 2)])
def test_round_robin_matches_reference_split(total, shard, num):
    idx = D.round_robin_indices(total, shard=shard, num_shards=num)
    np.testing.assert_array_equal(
        idx, JD.round_robin_indices(total, shard=shard, num_shards=num))
    everything = np.sort(np.concatenate(
        [D.round_robin_indices(total, s, num) for s in range(num)]))
    np.testing.assert_array_equal(everything, np.arange(total))
    if (total, shard, num) == (10, 1, 4):
        np.testing.assert_array_equal(idx, [1, 5, 9])


def test_single_process_collectives_are_the_identity():
    x = torch.randn(3, 2, requires_grad=True)
    assert D.gather_rows(x) is x and D.sum_across_ranks(x) is x
    g = torch.ones(2)
    p = torch.zeros(2, requires_grad=True)
    p.grad = g.clone()
    D.all_reduce_grads_([p])
    assert torch.equal(p.grad, g)


def test_create_mesh_is_the_process_group():
    assert M.create_mesh("cpu") == _cpu_mesh()


def _temporal_site(seed=0):
    """A tiny DecoderVideo attention site with a live temporal branch
    (blend weight 0.5) and rows of 5 frames a rank x 4 channels x 2x2."""
    torch.manual_seed(seed)
    site = _SpatialTemporalAttn(4, 2)
    with torch.no_grad():
        site.blend_weight.fill_(0.5)
    return site


@pytest.mark.parametrize("world,rank", [(2, 0), (2, 1), (3, 2)])
def test_row_split_attends_over_every_ranks_rows(world, rank):
    """A site given a `RowSplit` returns this rank's rows of the one-process
    output over all rows, and the gradient of its own rows' use of them
    (the gather's backward adds the other ranks' uses): its gather stands
    in for the other ranks' rows."""
    site = _temporal_site()
    rows = 5
    mine = slice(rank * rows, (rank + 1) * rows)
    x = torch.randn(world * rows, 4, 2, 2)
    coef = torch.randn(world * rows, 4, 2, 2)
    coef_mine = torch.zeros_like(coef)
    coef_mine[mine] = coef[mine]
    full_in = x.clone().requires_grad_(True)
    full = site(full_in, time=world * rows)
    (full_grad,) = torch.autograd.grad((full * coef_mine).sum(), [full_in])
    with torch.no_grad():
        others = site.attn(x.flatten(2).transpose(1, 2))

    def gather(t):
        return torch.cat([others[:mine.start], t, others[mine.stop:]])

    local_in = x[mine].clone().requires_grad_(True)
    local = site(local_in, time=rows, split=RowSplit(gather, mine))
    torch.testing.assert_close(local, full[mine].detach(), rtol=1e-6,
                               atol=1e-6)
    (local_grad,) = torch.autograd.grad((local * coef[mine]).sum(),
                                        [local_in])
    torch.testing.assert_close(local_grad, full_grad[mine], rtol=1e-5,
                               atol=1e-6)


def test_row_split_needs_all_of_each_ranks_rows():
    site = _temporal_site()
    with pytest.raises(ValueError, match="holds all of each rank"):
        site(torch.randn(4, 4, 2, 2), time=2,
             split=RowSplit(lambda t: t, slice(0, 4)))


def test_shard_batch_takes_contiguous_blocks():
    batch = {"voxel": np.arange(16 * 3, dtype=np.float32).reshape(16, 3),
             "label": np.arange(16)}
    for r in range(4):
        got = M.shard_batch(_cpu_mesh(4, r), batch)
        np.testing.assert_array_equal(got["voxel"].numpy(),
                                      batch["voxel"][4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.arange(4 * r, 4 * r + 4))
    assert M.local_rows(_cpu_mesh(4, 2), 8) == slice(4, 6)


def test_shard_batch_indivisible_raises():
    with pytest.raises(ValueError, match="does not divide"):
        M.shard_batch(_cpu_mesh(4, 0), {"x": np.ones((10, 2))})


def test_shard_batch_passes_device_tensors_unchanged():
    x = torch.ones(6, 2)  # on the mesh's device (the CPU) already
    assert M.shard_batch(_cpu_mesh(2, 1), {"x": x})["x"] is x


def test_prefetch_yields_shard_batch_in_order():
    mesh = _cpu_mesh(2, 1)
    batches = [{"a": np.full((4, 2), i, np.float32), "b": np.arange(4) + i}
               for i in range(5)]
    got = list(M.prefetch_to_device(iter(batches), mesh))
    assert len(got) == 5
    for g, b in zip(got, batches):
        want = M.shard_batch(mesh, b)
        assert set(g) == set(want)
        for k in want:
            assert torch.equal(g[k], want[k])


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_reads_at_most_size_ahead(size):
    read = []

    def source():
        for i in range(6):
            read.append(i)
            yield {"x": np.full((2, 1), i)}

    for k, _ in enumerate(M.prefetch_to_device(source(), _cpu_mesh(),
                                               size=size)):
        assert len(read) <= k + 1 + size
    assert read == list(range(6))


def test_world_one_mesh_step_is_the_plain_step_bitwise():
    """A mesh of one rank (no group) runs the stage-2 step of `mesh=None`
    bit for bit."""
    spec = _stage2_spec()
    batch = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    plain = one_stage2_step(spec, batch, None)
    meshed = one_stage2_step(spec, batch, _cpu_mesh())
    assert plain["metrics"] == meshed["metrics"]
    for n, g in plain["grads"].items():
        assert torch.equal(g, meshed["grads"][n]), n


# --------------------------------------------- the cases' global inputs ----

def _jax_stage1_params():
    shapes = jax.eval_shape(JCore(_jbcfg()).init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 1, _jbcfg().voxel_counts[0])))
    return randomize(shapes["params"], 11)


def _jbcfg():
    return jcfg.BrainModelConfig(**BCFG)


def _port_params(jparams):
    core = NeuronsCore(tcfg.BrainModelConfig(**BCFG))
    load_jax_params(core, jparams)
    return {n: p.detach().clone() for n, p in core.named_parameters()}


def _stage1_batch(seed=5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {"voxel": rng.standard_normal((B1, 1, _jbcfg().voxel_counts[0]),
                                         f32),
            "target": rng.standard_normal((B1, BCFG["clip_seq_dim"],
                                           BCFG["clip_emb_dim"]), f32),
            "text": rng.standard_normal((B1, BCFG["clip_txt_emb_dim"]), f32)}


def _jax_mixco_draws(key):
    """JAX's stage-1 mixup draws from its step key (train_brain.py:52,
    losses.py:38-41), as tests/test_torch_port_stage1.py rebuilds them."""
    k_mix, _ = jax.random.split(key)
    k_perm, k_beta, k_sel = jax.random.split(k_mix, 3)
    return tlosses.MixcoState(
        t(jax.random.permutation(k_perm, B1)).long(),
        t(jax.random.beta(k_beta, 0.15, 0.15, shape=(B1,))),
        torch.from_numpy(np.array(jax.random.uniform(k_sel, (B1,)) <= 0.5)))


def _stage2_spec():
    pcfg, _, _ = stage2_configs()
    batch = stage2_batch()
    diffusion = PriorDiffusion.create(pcfg.prior.timesteps,
                                      pcfg.prior.cond_drop_prob,
                                      device="cpu")
    draws = td.draw_stage2(diffusion, {k: torch.as_tensor(v) for k, v in
                                       batch.items()}, pcfg.decoupler,
                           torch.Generator().manual_seed(2))
    return {"batch": batch, "draws": draws}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _write_stage3(d: Path):
    g = np.random.default_rng(0)
    tio.save_stage3_artifacts(
        tio.stage3_dir(str(d / "EXP"), "exp1", 1, False), 1,
        all_recons=g.uniform(size=(CLIPS, 3, 8, 8)).astype(np.float32),
        all_gts=g.uniform(size=(CLIPS, 3, 8, 8)).astype(np.float32),
        captions=[f"clip {i}" for i in range(CLIPS)],
        blurry_videos=g.uniform(size=(CLIPS, 6, 3, 8, 8)).astype(np.float32))


def _inputs():
    jparams = _jax_stage1_params()
    params = _port_params(jparams)
    stage1_tcfg = dict(batch_size=B1, num_epochs=4, max_lr=0.01,
                       bf16_autocast=False)
    dropout = ttb.draw_stage1(tcfg.BrainModelConfig(**BCFG),
                              torch.zeros(B1, 1),
                              torch.Generator().manual_seed(4))
    return jparams, {
        "stage1": {"tcfg": stage1_tcfg, "params": params,
                   "batch": _stage1_batch(),
                   "draws": ttb.Stage1Draws(_jax_mixco_draws(STEP_KEY),
                                            None)},
        "stage1_dropout": {"tcfg": stage1_tcfg, "params": params,
                           "batch": _stage1_batch(6), "draws": dropout},
        "stage2": _stage2_spec(),
        "run_stage1": {"tcfg": dict(batch_size=B1, num_epochs=2,
                                    max_lr=1e-3, bf16_autocast=False,
                                    seed=3),
                       "params": params},
    }


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, the inputs, the JAX params and the run's
    directory; the ranks' output in rank{r}.log."""
    d = tmp_path_factory.mktemp("ranks")
    jparams, inputs = _inputs()
    torch.save(inputs, d / "inputs.pt")
    _write_stage3(d)
    env = dict(os.environ, PYTHONPATH=f"{REPO}{os.pathsep}{WORKER.parent}",
               OMP_NUM_THREADS="1", NEURONS_TPU_ALLOW_BYTE_TOKENIZER="1")
    for var in ("JAX_COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(var, None)
    port = _free_port()
    logs = [open(d / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(d), str(r), str(WORLD), str(port)],
        env=env, cwd=REPO, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        codes = [p.wait(timeout=RANK_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    text = {r: (d / f"rank{r}.log").read_text() for r in range(WORLD)}
    if codes != [0] * WORLD:
        pytest.fail(f"the ranks exited with {codes} (None: timed out after "
                    f"{RANK_TIMEOUT_S} s):\n" + "\n".join(
                        f"--- rank {r} ---\n{text[r][-3000:]}"
                        for r in range(WORLD)))
    out = [torch.load(d / f"rank{r}.pt", weights_only=False)
           for r in range(WORLD)]
    return {"out": out, "inputs": inputs, "jparams": jparams, "dir": d,
            "logs": text}


# ------------------------------------------------------- the two ranks ----

def test_two_rank_glue(two_ranks):
    x = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    w = torch.ones(4, requires_grad=True)
    (full,) = torch.autograd.grad(torch.mean((torch.from_numpy(x) @ w) ** 2),
                                  [w])
    for r, g in enumerate(o["glue"] for o in two_ranks["out"]):
        assert (g["rank"], g["world"], g["main"]) == (r, WORLD, r == 0)
        assert g["mesh"] == (WORLD, r)
        np.testing.assert_array_equal(g["broadcast"]["a"], np.arange(3))
        np.testing.assert_array_equal(
            g["allgather"]["x"], np.stack([np.full((2, 3), q)
                                           for q in range(WORLD)]))
        np.testing.assert_array_equal(g["round_robin"],
                                      np.arange(r, 10, WORLD))
        np.testing.assert_array_equal(g["rows"].numpy(),
                                      x[8 * r:8 * r + 8])
        torch.testing.assert_close(g["toy_grad"], full, rtol=1e-6, atol=0)
        assert torch.equal(g["gather"], torch.cat(
            [torch.full((2, 3), float(q + 1)) for q in range(WORLD)]))
        # rows 2r, 2r+1 of the gathered 4, coefficient summed over 2 ranks
        want = WORLD * torch.arange(2.0 * r, 2.0 * r + 2)[:, None]
        assert torch.equal(g["gather_grad"], want.expand(2, 3))
        assert g["sum"] == 3.0
        assert torch.equal(g["replicated"], torch.zeros(3))


def _err_norm(got, want):
    num = sum(float((got[n] - want[n]).double().pow(2).sum()) for n in want)
    den = sum(float(want[n].double().pow(2).sum()) for n in want)
    return (num / den) ** 0.5


def _one_process(spec, run):
    batch = {k: torch.as_tensor(v) for k, v in spec["batch"].items()}
    return run(spec, batch, None)


@pytest.mark.parametrize("case", ["stage1", "stage1_dropout", "stage2"])
def test_two_rank_step_equals_the_one_process_step(two_ranks, case):
    run = one_stage2_step if case == "stage2" else one_stage1_step
    want = _one_process(two_ranks["inputs"][case], run)
    ranks = [o["steps"][case] for o in two_ranks["out"]]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k, v in want["metrics"].items():
        assert abs(ranks[0]["metrics"][k] - v) <= 1e-6 * max(abs(v), 1.0), k
    assert set(ranks[0]["grads"]) == set(want["grads"])
    for r in ranks:
        err = _err_norm(r["grads"], want["grads"])
        print(f"{case}: gradient error norm {err:.3e}")
        assert err <= 1e-5, err
    for n in want["grads"]:  # every rank takes the same update
        assert torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]), n


def test_two_rank_stage1_loss_equals_jax(two_ranks, monkeypatch):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, *a, **kw: inputs)
    spec = two_ranks["inputs"]["stage1"]
    params = jax.tree_util.tree_map(jnp.asarray, two_ranks["jparams"])
    b = spec["batch"]
    _, metrics = jax.jit(lambda p, v, tg, tx: jtb.stage1_loss(
        JCore(_jbcfg()), p, STEP_KEY, v, tg, tx, 0.006, True, False))(
        params, b["voxel"], b["target"], b["text"])
    for o in two_ranks["out"]:
        got = o["steps"]["stage1"]["metrics"]
        for k in ("loss", "loss_clip_vision", "loss_clip_txt"):
            want = float(metrics[k])
            assert abs(got[k] - want) <= 1e-5 * abs(want), k


def test_two_rank_run_stage1(two_ranks, monkeypatch, tmp_path):
    """Rank 0 alone writes the tags and the metrics; both ranks take the
    decisions one process takes, and hold the same parameters."""
    spec = two_ranks["inputs"]["run_stage1"]
    calls = record_saves(monkeypatch)
    args, kw = stage1_run_args(spec)
    log = _Recorder()
    tloop.run_stage1(*args, ckpt_dir=str(tmp_path), logger=log,
                     device="cpu", **kw)
    ranks = [o["run_stage1"] for o in two_ranks["out"]]
    decisions = [(tag, epoch) for tag, epoch, _ in calls]
    assert decisions[-1] == ("brain_model_last", 1)
    for r in ranks:
        assert [(tag, epoch) for tag, epoch, _ in r["calls"]] == decisions
        assert r["calls"] == ranks[0]["calls"] and r["step"] == 4
    assert ranks[0]["written"] == sorted({tag for tag, _ in decisions})
    assert ranks[1]["written"] == []
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
    d = two_ranks["dir"] / "ckpt"
    assert sorted(os.listdir(d)) == sorted(
        {tag for tag, _ in decisions} | {"metrics.jsonl"})
    rows = [json.loads(line) for line in
            (d / "metrics.jsonl").read_text().splitlines()]
    assert len(rows) == 2 == len(log.rows)
    for got, want in zip(rows, log.rows):
        assert abs(got["train/mean_loss"] - want["train/mean_loss"]) <= (
            1e-4 * abs(want["train/mean_loss"]))
    assert "epoch 0 it 0" in two_ranks["logs"][0]
    assert "epoch 0" not in two_ranks["logs"][1]


def test_two_rank_resume_from_an_interrupted_swap(two_ranks):
    """`brain_model_last.old` without `brain_model_last` (a crash between
    the two renames of a save): rank 0 puts it back before any rank looks,
    and both ranks resume at epoch 2 and train the same third epoch."""
    ranks = [o["resume"] for o in two_ranks["out"]]
    for r in ranks:
        assert r["step"] == 6
        assert r["calls"] and {epoch for _, epoch, _ in r["calls"]} == {2}
        assert r["calls"] == ranks[0]["calls"]
    for n, p in ranks[0]["params"].items():
        assert torch.equal(p, ranks[1]["params"][n]), n
    assert "brain_model_last" in ranks[0]["tags"]
    assert not any(t.endswith(".old") for t in ranks[0]["tags"])
    assert "resumed brain_model_last at epoch 2" in two_ranks["logs"][0]
    assert "resumed" not in two_ranks["logs"][1]


def test_two_rank_video_shards_cover_the_clips_once(two_ranks):
    vdir = tio.video_dir(str(two_ranks["dir"] / "EXP"), "exp1", 1, "motion")
    gifs = sorted(os.listdir(vdir))
    assert sorted(int(g.split("-")[0]) for g in gifs) == list(range(CLIPS))
    for r in range(WORLD):
        assert (f"rank-scattered clips {r}::{WORLD}"
                in two_ranks["logs"][r])
        assert two_ranks["out"][r]["video"]["done"]


class _Recorder:
    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step=None):
        self.rows.append({k: float(v) for k, v in metrics.items()})

    def log_images(self, images, step=None):
        pass
