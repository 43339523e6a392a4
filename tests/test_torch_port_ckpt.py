"""Checkpoints of stages 1 and 2, on the CPU at tiny sizes.

The payload's round trip and atomic replace; `restore_into` and
`merge_overlays` against the JAX package's on the same nested trees;
`_restore_state` on the three payload generations (full tree, trained
subtree, params only) with its memory counter; a preempted and resumed
run against an uninterrupted one, bitwise, for both stages; the
background writer (round trip, snapshot, a surfaced error);
`load_stage1_core` and `load_decoupler_params` (the core artifact, a
stage-1 tag, and the error without either: the port's form of
tests/test_core_artifact.py); the stage-2 seg panel against the JAX
package's on the same weights and draws; and `MetricLogger`'s JSONL line
and image panel against the JAX package's.

Tolerances: the seg panel's masks 1e-5 relative to 1 (sigmoid values),
its resized ground truth equal; everything else equal.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.diffusion.prior import PriorDiffusion as JPriorDiffusion
from neurons_tpu.models import gpt2 as jgpt2
from neurons_tpu.models.neurons import NeuronsDecoupler as JDecoupler
from neurons_tpu.training import train_decoupler as jtd
from neurons_tpu.utils import checkpoint as jckpt
from neurons_tpu.utils import metrics_log as jmetrics_log
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.data import cc2017 as tcc
from neurons_tpu_torch.diffusion.prior import PriorDraws
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models.gpt2 import GPT2Config
from neurons_tpu_torch.models.neurons import NeuronsDecoupler
from neurons_tpu_torch.training import loop as tloop
from neurons_tpu_torch.training import train_brain as ttb
from neurons_tpu_torch.training import train_decoupler as ttd
from neurons_tpu_torch.utils import checkpoint as tckpt
from neurons_tpu_torch.utils.metrics_log import MetricLogger
from neurons_tpu_torch.utils.synth_init import synth_params_
from torch_port_utils import randomize, t

CFG = tcfg.tiny_pipeline_config()
GCFG = GPT2Config(*jgpt2.tiny_gpt2_config())
BCFG = tcfg.BrainModelConfig(hidden_dim=32, n_blocks=2, clip_seq_dim=4,
                             clip_emb_dim=16, clip_txt_emb_dim=8,
                             subjects=(3,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Recorder:
    """MetricLogger's interface, recording."""

    def __init__(self):
        self.rows, self.images = [], []

    def log_metrics(self, metrics, step=None):
        self.rows.append(dict(metrics))

    def log_images(self, images, step=None):
        self.images.append(images)


def _stage1_state(seed, tc=None):
    tc = tc or tcfg.TrainConfig(batch_size=4, num_epochs=2)
    return ttb.init_stage1(BCFG, tc, 2, seed=seed, device="cpu")


def _one_step(core, state, schedule, seed=0):
    rng = np.random.default_rng(seed)
    voxel = torch.from_numpy(rng.standard_normal(
        (4, 1, BCFG.voxel_counts[0]), dtype=np.float32))
    target = torch.randn(4, BCFG.clip_seq_dim, BCFG.clip_emb_dim)
    text = torch.randn(4, BCFG.clip_txt_emb_dim)
    step = ttb.make_stage1_train_step(core, schedule,
                                      tcfg.TrainConfig(bf16_autocast=False))
    return step(state, torch.Generator().manual_seed(seed), voxel, target,
                text)[0]


def _equal_trees(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal_trees(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal_trees, a, b))
    return a == b


# -------------------------------------------------------- the payload ----

def test_save_load_round_trip(tmp_path):
    core, state, schedule = _stage1_state(1)
    state = _one_step(core, state, schedule)
    params = dict(state.params, extra_bf16=torch.randn(3, 2).bfloat16())
    opt = state.optimizer.state_dict()
    tckpt.save_ckpt(str(tmp_path), "brain_model_last", params=params,
                    opt_state=opt, step=7, epoch=3,
                    extra={"best_metric": 1.5, "best_epoch": 2})
    got = tckpt.load_ckpt(str(tmp_path), "brain_model_last")
    assert got["step"] == 7 and got["epoch"] == 3
    assert got["extra"] == {"best_metric": 1.5, "best_epoch": 2}
    assert _equal_trees(got["params"], {k: v.detach() for k, v in
                                        params.items()})
    assert _equal_trees(got["opt_state"], opt)
    stats = tckpt.LAST_SAVE_STATS["brain_model_last"]
    assert stats["bytes"] == os.path.getsize(
        tmp_path / "brain_model_last" / tckpt.PAYLOAD)
    assert stats["copy_s"] >= 0 and stats["write_s"] > 0
    # params only, no extra
    tckpt.save_ckpt(str(tmp_path), "brain_model", params={"w": torch.ones(2)})
    got = tckpt.load_ckpt(str(tmp_path), "brain_model")
    assert "opt_state" not in got and "extra" not in got


def test_atomic_replace(tmp_path):
    d = str(tmp_path)
    tckpt.save_ckpt(d, "tag", params={"w": torch.zeros(3)}, epoch=1)
    # a write cut short leaves <tag>.tmp: it is not a tag and the old
    # payload stays whole
    os.makedirs(tmp_path / "other.tmp")
    (tmp_path / "other.tmp" / tckpt.PAYLOAD).write_bytes(b"half")
    assert not tckpt.exists(d, "other")
    os.makedirs(tmp_path / "tag.tmp")
    (tmp_path / "tag.tmp" / tckpt.PAYLOAD).write_bytes(b"half")
    assert tckpt.load_ckpt(d, "tag")["epoch"] == 1
    # the next save replaces the tag and clears the leftover
    tckpt.save_ckpt(d, "tag", params={"w": torch.ones(3)}, epoch=2)
    assert tckpt.load_ckpt(d, "tag")["epoch"] == 2
    assert sorted(os.listdir(d)) == ["other.tmp", "tag"]
    # a crash between the swap's renames leaves <tag>.old alone: put back
    os.replace(tmp_path / "tag", tmp_path / "tag.old")
    assert tckpt.exists(d, "tag")
    assert tckpt.load_ckpt(d, "tag")["epoch"] == 2
    # ...and beside a complete tag it is dropped
    tckpt.save_ckpt(d, "tag.old", params={"w": torch.ones(1)})
    os.replace(tmp_path / "tag.old", tmp_path / "stale")
    os.makedirs(tmp_path / "tag.old")
    assert tckpt.exists(d, "tag") and not os.path.exists(tmp_path / "tag.old")


def _nested(rng):
    return {"core": {"w": rng.standard_normal(3), "b": rng.standard_normal(2)},
            "head": {"w": rng.standard_normal(4),
                     "sub": {"x": rng.standard_normal(1)}},
            "only_target": {"y": rng.standard_normal(2)}}


def test_restore_into_and_merge_overlays_match_jax():
    rng = np.random.default_rng(0)
    target = _nested(rng)
    ckpt = {"core": {"w": rng.standard_normal(3)},
            "head": {"sub": {"x": rng.standard_normal(1)}},
            "not_in_target": {"z": rng.standard_normal(1)}}
    later = {"head": {"w": rng.standard_normal(4)}, "new": {"q": 1.0}}

    def same(a, b):
        return jax.tree_util.tree_all(jax.tree_util.tree_map(
            lambda x, y: np.array_equal(x, y), a, b))

    assert same(tckpt.restore_into(target, ckpt),
                jckpt.restore_into(target, ckpt))
    assert same(tckpt.merge_overlays(ckpt, None, later),
                jckpt.merge_overlays(ckpt, None, later))
    assert tckpt.merge_overlays(None) is None is jckpt.merge_overlays(None)
    # the flat {name: tensor} payloads are one-level trees
    flat = {"a.w": torch.zeros(2), "b.w": torch.zeros(2)}
    out = tckpt.restore_into(flat, {"a.w": torch.ones(2), "c.w": 3})
    assert out.keys() == flat.keys() and torch.equal(out["a.w"],
                                                     torch.ones(2))


# ------------------------------------------------------------ restore ----

def test_restore_full_tree_in_place(tmp_path):
    core, state, schedule = _stage1_state(1)
    state = _one_step(core, state, schedule)
    tckpt.save_ckpt(str(tmp_path), "last", params=state.params,
                    opt_state=state.optimizer.state_dict(), step=state.step,
                    epoch=4, extra={"best_metric": 0.5})
    core2, fresh, _ = _stage1_state(2)
    live = {n: p.data_ptr() for n, p in fresh.params.items()}
    moments = {id(p): s["exp_avg"].data_ptr()
               for p, s in fresh.optimizer.state.items()}
    new, start, extra = tloop._restore_state(str(tmp_path), "last", fresh)
    assert (new.step, start, extra) == (1, 5, {"best_metric": 0.5})
    for n, p in new.params.items():
        assert torch.equal(p, state.params[n]), n
        assert p.data_ptr() == live[n], n  # copied in place
    assert _equal_trees(new.optimizer.state_dict()["state"],
                        state.optimizer.state_dict()["state"])
    for p, s in new.optimizer.state.items():
        assert s["exp_avg"].data_ptr() == moments[id(p)]
    stats = tloop.LAST_RESTORE_STATS
    nbytes = sum(p.numel() * 4 for p in state.params.values()) + sum(
        v.numel() * v.element_size() for s in state.optimizer.state.values()
        for v in s.values())
    assert stats["peak_extra_bytes"] == 0 and stats["put_bytes"] == 0
    assert stats["copied_bytes"] == nbytes


def test_restore_trained_subtree_keeps_the_core(tmp_path):
    tc = tcfg.replace(CFG.train, bf16_autocast=False)
    _, a = ttd.init_stage2(CFG.brain, CFG.prior, CFG.decoupler, tc, GCFG, 2,
                           seed=1, device="cpu")
    _, b = ttd.init_stage2(CFG.brain, CFG.prior, CFG.decoupler, tc, GCFG, 2,
                           seed=2, device="cpu")
    tckpt.save_ckpt(str(tmp_path), "last", params=tloop._sans_core(a.params),
                    opt_state=a.optimizer.state_dict(), step=6, epoch=2)
    core_before = {n: p.clone() for n, p in b.params.items()
                   if ttd.is_core(n)}
    new, start, _ = tloop._restore_state(str(tmp_path), "last", b)
    assert (new.step, start) == (6, 3)
    for n, p in new.params.items():
        want = core_before[n] if ttd.is_core(n) else a.params[n]
        assert torch.equal(p, want), n


def test_restore_params_only_restarts_the_optimizer(tmp_path, capsys):
    core, state, schedule = _stage1_state(1)
    state = _one_step(core, state, schedule)
    tckpt.save_ckpt(str(tmp_path), "p", params=state.params, step=9, epoch=0)
    _, fresh, _ = _stage1_state(2)
    new, start, _ = tloop._restore_state(str(tmp_path), "p", fresh)
    assert (new.step, start) == (0, 1)
    assert "restart" in capsys.readouterr().out
    for n, p in new.params.items():
        assert torch.equal(p, state.params[n])
    for s in new.optimizer.state.values():
        assert not s["exp_avg"].any() and float(s["step"]) == 0
    # an optimizer state that does not fit (another model's) is left out
    # whole, with the same restart
    _, other, _ = ttb.init_stage1(tcfg.replace(BCFG, n_blocks=1),
                                  tcfg.TrainConfig(), 2, device="cpu")
    tckpt.save_ckpt(str(tmp_path), "q", params=state.params,
                    opt_state=other.optimizer.state_dict(), step=9)
    _, fresh, _ = _stage1_state(2)
    new, _, _ = tloop._restore_state(str(tmp_path), "q", fresh)
    assert new.step == 0 and "does not fit" in capsys.readouterr().out
    for s in new.optimizer.state.values():
        assert not s["exp_avg"].any()


def test_restore_takes_the_payload_type_one_tensor_at_a_time(tmp_path):
    """A bf16 payload tensor replaces an f32 live one (restore first, then
    cast): the counter holds one tensor above the live state at most."""
    _, state, _ = _stage1_state(1)
    payload = {n: (p.detach().bfloat16() if n.startswith("backbone.")
                   else p.detach()) for n, p in state.params.items()}
    tckpt.save_ckpt(str(tmp_path), "t", params=payload)
    _, fresh, _ = _stage1_state(2)
    new, _, _ = tloop._restore_state(str(tmp_path), "t", fresh)
    for n, p in new.params.items():
        assert p.dtype == payload[n].dtype and torch.equal(p, payload[n]), n
    stats = tloop.LAST_RESTORE_STATS
    largest = max(v.numel() * v.element_size() for v in payload.values())
    assert 0 < stats["peak_extra_bytes"] <= largest
    assert stats["put_bytes"] == sum(v.numel() * 2 for n, v in
                                     payload.items()
                                     if n.startswith("backbone."))


# ------------------------------------------------ preemption and resume ----

def _stage1_data():
    kw = dict(seq=BCFG.clip_seq_dim, emb=BCFG.clip_emb_dim,
              txt_dim=BCFG.clip_txt_emb_dim, n_frames=4)
    train, table, _ = tcc.structured_synthetic_split(8, BCFG.voxel_counts[0],
                                                     **kw)
    test, test_table, _ = tcc.structured_synthetic_split(
        4, BCFG.voxel_counts[0], seed=1, train=False, **kw)
    return train, test, table, test_table


def test_stage1_preempt_and_resume_equals_an_uninterrupted_run(tmp_path):
    tc = tcfg.TrainConfig(batch_size=4, num_epochs=3, max_lr=3e-3,
                          bf16_autocast=False)
    data = _stage1_data()
    full = tloop.run_stage1(BCFG, tc, *data, ckpt_dir=str(tmp_path / "a"),
                            logger=Recorder(), device="cpu")
    rec = Recorder()
    d = str(tmp_path / "b")
    cut = tloop.run_stage1(BCFG, tc, *data, ckpt_dir=d, logger=rec,
                           stop_after_epochs=1, device="cpu")
    assert cut.step == 2 and tckpt.exists(d, "brain_model_last")
    assert tckpt.load_ckpt(d, "brain_model_last")["epoch"] == 0
    resumed = tloop.run_stage1(BCFG, tc, *data, ckpt_dir=d, logger=rec,
                               resume=True, device="cpu")
    assert resumed.step == full.step == 6
    for n, p in full.params.items():
        assert torch.equal(p, resumed.params[n]), n
    assert _equal_trees(full.optimizer.state_dict(),
                        resumed.optimizer.state_dict())
    assert tloop.LAST_RESTORE_STATS["peak_extra_bytes"] == 0
    for tag in ("brain_model", "brain_model_last"):
        a = tckpt.load_ckpt(str(tmp_path / "a"), tag)
        b = tckpt.load_ckpt(d, tag)
        assert _equal_trees(a, b), tag


def _stage2_run(d, tc, **kw):
    split, table, aux = tcc.structured_synthetic_split(
        8, CFG.brain.voxel_counts[0], seq=CFG.brain.clip_seq_dim,
        emb=CFG.brain.clip_emb_dim, txt_dim=CFG.decoupler.clip_txt_emb_dim,
        n_frames=CFG.decoupler.n_frames, n_classes=CFG.decoupler.num_classes)
    builder = tloop.structured_stage2_batch_builder(
        table, aux, split, CFG.decoupler, GCFG.vocab_size)
    return tloop.run_stage2(CFG.brain, CFG.prior, CFG.decoupler, tc, GCFG,
                            split, builder, ckpt_dir=d, logger=Recorder(),
                            bf16_frozen_core=True, device="cpu", **kw)


def test_stage2_preempt_and_resume_equals_an_uninterrupted_run(tmp_path):
    tc = tcfg.replace(CFG.train, num_epochs=3)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full = _stage2_run(a, tc, image_log_every=0)
    cut = _stage2_run(b, tc, image_log_every=0, stop_after_epochs=1)
    assert cut.step == 2
    mid = tckpt.load_ckpt(b, "brain_model_prior_last")
    assert not any(ttd.is_core(n) for n in mid["params"])  # sans core
    resumed = _stage2_run(b, tc, image_log_every=0, resume=True)
    assert resumed.step == full.step == 6
    for n, p in full.params.items():
        assert p.dtype == resumed.params[n].dtype, n
        assert torch.equal(p, resumed.params[n]), n
    # the final `_last` holds the full tree, its core in bf16; resuming a
    # finished run restores it (payload types first, then the cast)
    last = tckpt.load_ckpt(a, "brain_model_prior_last")["params"]
    assert last["core.clipproj.proj"].dtype == torch.bfloat16
    again = _stage2_run(a, tc, image_log_every=0, resume=True)
    assert again.step == full.step
    for n, p in full.params.items():
        assert torch.equal(p, again.params[n]), n


def test_stage2_checkpoint_contract(tmp_path, monkeypatch):
    """Tags written with last_save_every=1 and async saves: the core
    artifact once, the sans-core mid-run saves, the full tree at the end;
    the seg panels logged each epoch; the tags overlaid by
    load_decoupler_params equal the trained state."""
    saves = []
    real = tckpt.save_ckpt

    def save(directory, tag, **kw):
        names = list(kw["params"])
        saves.append((tag, kw.get("epoch", 0),
                      sum(n.startswith("core.") for n in names), len(names)))
        return real(directory, tag, **kw)

    monkeypatch.setattr(tckpt, "save_ckpt", save)
    tc = tcfg.replace(CFG.train, num_epochs=2)
    d = str(tmp_path)
    rec = Recorder()
    split = tcc.synthetic_split(n=8, n_voxels=CFG.brain.voxel_counts[0],
                                n_frames=CFG.decoupler.n_frames)
    state = tloop.run_stage2(
        CFG.brain, CFG.prior, CFG.decoupler, tc, GCFG, split,
        tloop.synthetic_stage2_batch_builder(CFG.brain, CFG.decoupler,
                                             GCFG.vocab_size),
        ckpt_dir=d, logger=rec, bf16_frozen_core=True, last_save_every=1,
        async_saves=True, device="cpu")
    assert [s[:2] for s in saves] == [
        ("brain_model_core", 0), ("brain_model_prior", 0),
        ("brain_model_prior_last", 0), ("brain_model_prior", 1),
        ("brain_model_prior_last", 1), ("brain_model_prior_last", 1)]
    n_core, n_all = saves[0][2], len(state.params)
    assert saves[0][2:] == (n_core, n_core)       # the core alone
    for s in saves[1:-1]:
        assert s[2:] == (0, n_all - n_core)       # the trained subtree
    assert saves[-1][2:] == (n_core, n_all)       # the full tree at the end
    core = tckpt.load_ckpt(d, "brain_model_core")["params"]
    assert core["core.clipproj.proj"].dtype == torch.bfloat16
    assert len(rec.images) == 2
    pred, gt = rec.images[0]["seg_pred"], rec.images[0]["seg_gt"]
    assert pred.shape == gt.shape == (4 * CFG.decoupler.n_frames, 16, 16)
    assert ((pred > 0) & (pred < 1)).all() and set(np.unique(gt)) <= {0, 1}
    fresh = NeuronsDecoupler(CFG.brain, CFG.prior, CFG.decoupler, GCFG,
                             device="cpu")
    tckpt.load_decoupler_params(d, fresh)
    for n, p in fresh.named_parameters():
        assert torch.equal(p.to(state.params[n].dtype), state.params[n]), n


# -------------------------------------------------------- async writer ----

def test_async_writer_round_trip_snapshot_and_error(tmp_path):
    d = str(tmp_path)
    w = tckpt.AsyncCkptWriter()
    p = {"w": torch.arange(4.0)}
    w.submit(d, "a", params=p, step=3, epoch=1)
    p["w"].add_(100)  # the snapshot was taken at submit
    w.drain()
    got = tckpt.load_ckpt(d, "a")
    assert torch.equal(got["params"]["w"], torch.arange(4.0))
    assert got["step"] == 3
    # a write that fails (its directory is a file) surfaces at drain, and
    # at the next submit until drain reports it
    (tmp_path / "file").write_text("x")
    w.submit(str(tmp_path / "file"), "b", params=p)
    w._q.join()
    with pytest.raises(FileExistsError):
        w.submit(d, "c", params=p)
    with pytest.raises(FileExistsError):
        w.drain()
    w.drain()  # reported once
    w.close()
    assert not w._thread.is_alive()
    w2 = tckpt.AsyncCkptWriter()
    w2.abort()
    assert not w2._thread.is_alive()


# ------------------------------------------- consumers of trained tags ----

def _decoupler(seed):
    m = NeuronsDecoupler(CFG.brain, CFG.prior, CFG.decoupler, GCFG,
                         device="cpu")
    return synth_params_(m, seed)


def test_load_decoupler_params_overlays_the_core_artifact(tmp_path):
    d = str(tmp_path)
    trained = dict(_decoupler(1).named_parameters())
    heads = tloop._sans_core(trained)
    core = {n: p for n, p in trained.items() if ttd.is_core(n)}
    tckpt.save_ckpt(d, "brain_model_prior_last", params=heads)
    tckpt.save_ckpt(d, "brain_model_core", params=core)
    # a stage-1 tag too: the artifact takes precedence
    tckpt.save_ckpt(d, "brain_model_last", params={
        n[len("core."):]: torch.zeros_like(p) for n, p in core.items()})
    out = tckpt.load_decoupler_params(d, _decoupler(2))
    for n, p in out.named_parameters():
        assert torch.equal(p, trained[n]), n


def test_load_decoupler_params_takes_a_stage1_tag(tmp_path):
    d = str(tmp_path)
    trained = dict(_decoupler(1).named_parameters())
    tckpt.save_ckpt(d, "brain_model_prior_last",
                    params=tloop._sans_core(trained))
    tckpt.save_ckpt(d, "brain_model", params={
        n[len("core."):]: p for n, p in trained.items() if ttd.is_core(n)})
    out = tckpt.load_decoupler_params(d, _decoupler(2))
    for n, p in out.named_parameters():
        assert torch.equal(p, trained[n]), n
    assert tckpt.load_stage1_core(d).keys() == {
        n[len("core."):] for n in trained if ttd.is_core(n)}


def test_load_decoupler_params_raises_without_a_core(tmp_path):
    d = str(tmp_path)
    trained = dict(_decoupler(1).named_parameters())
    tckpt.save_ckpt(d, "brain_model_prior_last",
                    params=tloop._sans_core(trained))
    with pytest.raises(RuntimeError, match="refusing"):
        tckpt.load_decoupler_params(d, _decoupler(2))
    with pytest.raises(FileNotFoundError):
        tckpt.load_decoupler_params(str(tmp_path / "none"), _decoupler(2))
    assert tckpt.load_stage1_core(d) is None


def test_load_stage1_core_prefers_the_best_tag(tmp_path):
    d = str(tmp_path)
    tckpt.save_ckpt(d, "brain_model_last", params={"w": torch.zeros(2)})
    assert torch.equal(tckpt.load_stage1_core(d)["w"], torch.zeros(2))
    tckpt.save_ckpt(d, "brain_model", params={"w": torch.ones(2)})
    assert torch.equal(tckpt.load_stage1_core(d)["w"], torch.ones(2))


# -------------------------------------------------------- the seg panel ----

JCFG = jcfg.tiny_pipeline_config()


def _jax_prior_draws(key, shape, timesteps, drop):
    """The draws of JAX's p_losses from its key (diffusion/prior.py:51-58,
    models/prior.py:322-329)."""
    b = shape[0]
    k_t, k_noise, k_drop = jax.random.split(key, 3)
    rb, ri = jax.random.split(k_drop)
    keep = [np.asarray(jax.random.uniform(r, (b, 1, 1)) >= drop).reshape(b)
            for r in (rb, ri)]
    return PriorDraws(
        t(jax.random.randint(k_t, (b,), 0, timesteps)).long(),
        t(jax.random.normal(k_noise, shape, jnp.float32)),
        torch.from_numpy(keep[0].copy()), torch.from_numpy(keep[1].copy()))


def test_seg_panel_matches_jax():
    jmod = JDecoupler(JCFG.brain, JCFG.prior, JCFG.decoupler,
                      jgpt2.tiny_gpt2_config())
    params = randomize(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0),
        jnp.zeros((2, 1, JCFG.brain.voxel_counts[0])),
        jnp.zeros((2, 8), jnp.int32))["params"], 41)
    rng = np.random.default_rng(3)
    c, f = JCFG.brain, JCFG.decoupler.n_frames
    b = 4
    batch = {
        "voxel": rng.standard_normal((b, 1, c.voxel_counts[0]), np.float32),
        "clip_vision_target": rng.standard_normal(
            (b, c.clip_seq_dim, c.clip_emb_dim), np.float32),
        "key_obj_text_embed": rng.standard_normal(
            (b, JCFG.decoupler.clip_txt_emb_dim), np.float32),
        "key_obj_masks": (rng.random((b, f, 40, 40)) < 0.3).astype(
            np.float32)}
    key = jax.random.PRNGKey(6)
    diff = JPriorDiffusion.create(JCFG.prior.timesteps,
                                  JCFG.prior.cond_drop_prob)
    panel = jtd.make_stage2_seg_panel_fn(jtd.Stage2Bundle(jmod, diff, None),
                                         JCFG.decoupler)
    want_pred, want_gt = panel(jax.tree_util.tree_map(jnp.asarray, params),
                               key, {k: jnp.asarray(v)
                                     for k, v in batch.items()})
    bundle, state = ttd.init_stage2(CFG.brain, CFG.prior, CFG.decoupler,
                                    CFG.train, GCFG, 2, device="cpu")
    load_jax_params(bundle.model, params)
    draws = _jax_prior_draws(key, batch["clip_vision_target"].shape,
                             JCFG.prior.timesteps, JCFG.prior.cond_drop_prob)
    pred, gt = ttd.make_stage2_seg_panel_fn(bundle, CFG.decoupler)(
        state.params, draws, {k: t(v) for k, v in batch.items()})
    assert float((pred - t(want_pred)).abs().max()) <= 1e-5
    assert torch.equal(gt, t(want_gt))
    assert pred.shape == (b * f, 16, 16)


# -------------------------------------------------------- the logger ----

def test_metric_logger_matches_jax(tmp_path, monkeypatch):
    rows = {}
    panel = np.linspace(0, 1, 2 * 5 * 6, dtype=np.float32).reshape(2, 5, 6)
    for name, cls in (("jax", jmetrics_log.MetricLogger),
                      ("port", MetricLogger)):
        lg = cls(log_dir=str(tmp_path / name))
        lg.log_metrics({"epoch": 1, "train/mean_loss": np.float32(0.5),
                        "note": "x"}, step=4)
        lg.log_images({"seg_pred": panel}, step=4)
        lg.close()
        line = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        assert len(line) == 1
        rows[name] = json.loads(line[0])
        rows[name].pop("_time")
    assert rows["port"] == rows["jax"] == {
        "epoch": 1.0, "train/mean_loss": 0.5, "note": "x", "_step": 4}
    import imageio.v2 as imageio
    png = [imageio.imread(tmp_path / n / "images" / "step4_seg_pred.png")
           for n in ("jax", "port")]
    np.testing.assert_array_equal(png[0], png[1])
    assert png[1].shape == (5, 12)  # the batch tiled on the width
    # without imageio the panel is kept as the uint8 array
    monkeypatch.setitem(sys.modules, "imageio", None)
    lg = MetricLogger(log_dir=str(tmp_path / "npy"))
    lg.log_images({"seg_gt": torch.from_numpy(panel)}, step=None)
    lg.close()
    got = np.load(tmp_path / "npy" / "images" / "seg_gt.png.npy")
    np.testing.assert_array_equal(got, png[1])
    # without a log_dir nothing is written
    MetricLogger().log_metrics({"a": 1})
