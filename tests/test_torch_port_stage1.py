"""Stage-1 training, port against JAX package, on the CPU at tiny sizes.

The losses and metrics stage 1 adds (`mixco` with JAX's draws, the soft
targets with a fixed point of the permutation, `mixco_nce` with a mixup
state, `batchwise_cosine_similarity`, `topk_accuracy` with a tie), the
`clipproj` freeze against optax's mask, the mixer dropout's masks,
`stage1_loss` and its gradients and one `make_stage1_train_step` in f32
and in bf16 autocast, the eval step, and `run_stage1` (2 epochs of 2
steps: epoch means, eval metrics, the tags written at each epoch with
their extras, the final parameters; and the best-metric throttle of
`best_save_every=2` over 4 epochs) from the same initial weights.

JAX PRNG and torch RNG never agree, so the tests rebuild JAX's draws from
its key splits (train_brain.py:52, losses.py:38-41; the step keys of
utils/prng.py:epoch_key) and pass them to the port. Dropout is off on
both sides where outputs are compared: the JAX side through a test-local
patch of flax's Dropout, the port's by passing no masks.

Tolerances (relative to max |JAX| unless stated): mixup, soft targets and
similarities 1e-6; the retrieval metrics equal; f32 loss terms 1e-5,
gradients 1e-4 (with a floor, and the vanishing gradients of the mix1
path 1e-4 of the largest, see the test), parameters after one step
1e-3 x lr where the gradient is well above rounding noise; bf16 autocast
loss terms 2e-2 and gradients 5e-2 of each tensor's largest (bf16 keeps 8
bits, and the two frameworks round at other places); `run_stage1` (max_lr
1e-3) epoch means 1e-4, final parameters 1e-2 x the summed learning rates
of the run (four Adam steps, each moving an element by at most about lr)
for all but 1e-4 of each tensor's elements (an element whose gradient is
rounding noise of the mix1 path, below, may step the other way: those
within twice the sum); the mix1 path's own tensors, whose gradients
vanish in exact arithmetic, within Adam's bound.
"""

import dataclasses
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.config import MeshConfig
from neurons_tpu.data import cc2017 as jcc
from neurons_tpu.models.neurons import NeuronsCore as JCore
from neurons_tpu.parallel import create_mesh
from neurons_tpu.training import loop as jloop
from neurons_tpu.training import losses as jlosses
from neurons_tpu.training import optimizers as jopt
from neurons_tpu.training import train_brain as jtb
from neurons_tpu.utils import checkpoint as jckpt
from neurons_tpu.utils.prng import epoch_key, root_key
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.data import cc2017 as tcc
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import brain as tbrain
from neurons_tpu_torch.models.neurons import NeuronsCore
from neurons_tpu_torch.training import loop as tloop
from neurons_tpu_torch.training import losses as tlosses
from neurons_tpu_torch.training import optimizers as topt
from neurons_tpu_torch.training import train_brain as ttb
from neurons_tpu_torch.utils import checkpoint as tckpt
from neurons_tpu_torch.utils.prng import epoch_generator
from torch_port_utils import randomize, rel_err, t

KEY = jax.random.PRNGKey(0)
B = 8  # the JAX loop shards the batch over the 8 virtual CPU devices
BCFG = jcfg.BrainModelConfig(hidden_dim=32, n_blocks=2, clip_seq_dim=4,
                             clip_emb_dim=16, clip_txt_emb_dim=8,
                             subjects=(3,))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def no_jax_dropout(monkeypatch):
    """flax's Dropout as the identity, for this test only."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, *a, **kw: inputs)


def port_cfg(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def jax_mixco_draws(k_mix, b):
    """The raw draws of JAX's mixco from its key (losses.py:38-41)."""
    k_perm, k_beta, k_sel = jax.random.split(k_mix, 3)
    return tlosses.MixcoState(
        t(jax.random.permutation(k_perm, b)).long(),
        t(jax.random.beta(k_beta, 0.15, 0.15, shape=(b,))),
        torch.from_numpy(np.array(jax.random.uniform(k_sel, (b,)) <= 0.5)))


def jax_step_draws(key, b):
    """A stage-1 step's draws from its key (train_brain.py:52), dropout
    off."""
    k_mix, _ = jax.random.split(key)
    return ttb.Stage1Draws(jax_mixco_draws(k_mix, b), None)


# ------------------------------------------------------ losses, metrics ----

def test_mixco_matches_jax():
    rng = np.random.default_rng(0)
    voxels = _rand(rng, 16, 1, 40)
    key = jax.random.PRNGKey(5)
    want, wstate = jlosses.mixco(key, jnp.asarray(voxels))
    got, state = tlosses.mixco(torch.from_numpy(voxels),
                               jax_mixco_draws(key, 16))
    assert rel_err(got, want) <= 1e-6
    assert torch.equal(state.perm, t(wstate.perm).long())
    assert rel_err(state.betas, wstate.betas) <= 1e-6
    assert torch.equal(state.select, torch.from_numpy(
        np.array(wstate.select)))
    assert 0 < int(state.select.sum()) < 16  # both arms taken


def test_mix_probs_overwrites_a_fixed_point_as_jax():
    perm = np.array([2, 1, 0, 4, 3])  # perm[1] == 1
    betas = np.array([0.3, 0.6, 1.0, 0.8, 0.1], np.float32)
    select = np.array([True, True, False, True, True])
    want = jlosses._mix_probs(jlosses.MixcoState(
        jnp.asarray(perm), jnp.asarray(betas), jnp.asarray(select)))
    got = tlosses._mix_probs(tlosses.MixcoState(
        torch.from_numpy(perm), torch.from_numpy(betas),
        torch.from_numpy(select)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[1, 1] == 1 - betas[1]  # overwritten, not beta


def test_mixco_nce_with_state_matches_jax():
    rng = np.random.default_rng(1)
    preds = jlosses.l2norm(jnp.asarray(_rand(rng, 8, 24)))
    targs = jlosses.l2norm(jnp.asarray(_rand(rng, 8, 24)))
    key = jax.random.PRNGKey(7)
    _, wstate = jlosses.mixco(key, jnp.zeros((8, 3)))
    _, state = tlosses.mixco(torch.zeros(8, 3), jax_mixco_draws(key, 8))
    for temp in (0.006, 0.1):
        for bidi in (True, False):
            want = jlosses.mixco_nce(preds, targs, temp, wstate, bidi)
            got = tlosses.mixco_nce(t(preds), t(targs), temp, state, bidi)
            assert rel_err(got, want) <= 1e-6, (temp, bidi)


def test_batchwise_cosine_similarity_matches_jax():
    rng = np.random.default_rng(2)
    z, b = _rand(rng, 6, 4, 5), _rand(rng, 6, 20)
    want = jlosses.batchwise_cosine_similarity(jnp.asarray(z), jnp.asarray(b))
    got = tlosses.batchwise_cosine_similarity(t(z), t(b))
    assert rel_err(got, want) <= 1e-6


def test_topk_accuracy_with_tie_matches_jax():
    rng = np.random.default_rng(3)
    sims = rng.integers(0, 4, (12, 12)).astype(np.float32)  # many ties
    sims[0, :] = 1.0                                         # a row all tied
    labels = np.arange(12)
    for k in (1, 5, 20):
        want = float(jlosses.topk_accuracy(jnp.asarray(sims),
                                           jnp.asarray(labels), k))
        got = float(tlosses.topk_accuracy(t(sims), torch.from_numpy(labels),
                                          k))
        assert got == want, k
    # the tied row ranks its last column first, as jnp.argsort orders it
    one = np.zeros((2, 2), np.float32)
    assert float(tlosses.topk_accuracy(t(one), torch.tensor([1, 1]), 1)) \
        == float(jlosses.topk_accuracy(jnp.asarray(one), jnp.array([1, 1]),
                                       1)) == 1.0


def test_check_loss_and_count_params(capsys):
    assert tlosses.check_loss(torch.tensor(1.5)) == 1.5
    tlosses.check_loss(torch.tensor(float("nan")), "x")
    assert "non-finite x" in capsys.readouterr().out
    core = NeuronsCore(port_cfg(tcfg.BrainModelConfig, BCFG))
    shapes = jax.eval_shape(JCore(BCFG).init, KEY,
                            jnp.zeros((2, 1, BCFG.voxel_counts[0])))
    assert tlosses.count_params(core) == jlosses.count_params(shapes)


def test_draws_keep_fraction_scale_and_seed():
    cfg = port_cfg(tcfg.BrainModelConfig, BCFG)
    big = tcfg.replace(cfg, hidden_dim=4096)

    def draw(seed):
        return ttb.draw_stage1(big, torch.zeros(64, 1, 3),
                               torch.Generator().manual_seed(seed))

    a, b_, c = draw(1), draw(1), draw(2)
    for m, n, o in zip(a.dropout.mix1 + a.dropout.mix2,
                       b_.dropout.mix1 + b_.dropout.mix2,
                       c.dropout.mix1 + c.dropout.mix2):
        assert torch.equal(m, n) and not torch.equal(m, o)
        assert abs(m.float().mean().item() - (1 - big.dropout)) < 0.01
    assert a.dropout.mix1[0].shape == (64, 1, 4096)
    assert a.dropout.mix2[0].shape == (64, 4096, 1)
    assert len(a.dropout.mix1) == big.n_blocks
    assert torch.equal(a.mixco.perm, b_.mixco.perm)
    assert sorted(a.mixco.perm.tolist()) == list(range(64))
    assert ((a.mixco.betas >= 0) & (a.mixco.betas <= 1)).all()
    assert 0 < int(a.mixco.select.sum()) < 64
    # the scale: kept elements / (1 - rate), the rest zero
    mlp = tbrain._MixerMLP(8, 8)
    x, keep = torch.randn(3, 1, 8), torch.rand(3, 1, 8) < 0.85
    h = torch.nn.functional.gelu(mlp.Dense_0(x))
    want = mlp.Dense_1(torch.where(keep, h / 0.85, torch.zeros_like(h)))
    torch.testing.assert_close(mlp(x, keep, 0.15), want, rtol=0, atol=0)
    # the same generator seed gives the same draws on every run
    s1 = epoch_generator(3, 1, 2).initial_seed()
    assert s1 == epoch_generator(3, 1, 2).initial_seed()
    assert s1 != epoch_generator(3, 2, 1).initial_seed()


def test_freeze_by_prefix_adamw_matches_masked_optax():
    rng = np.random.default_rng(4)
    tree = {"clipproj": {"proj": _rand(rng, 6, 4)},
            "backbone": {"clip_proj": {"w": _rand(rng, 5, 3)}},
            "ridge": {"w": _rand(rng, 7)}}
    flat = {"clipproj.proj": tree["clipproj"]["proj"],
            "backbone.clip_proj.w": tree["backbone"]["clip_proj"]["w"],
            "ridge.w": tree["ridge"]["w"]}
    kw = dict(max_lr=0.01, weight_decay=0.1, num_epochs=4)
    tx, _ = jopt.make_optimizer(jcfg.TrainConfig(**kw), 3,
                                frozen_fn=jopt.freeze_by_prefix(("clipproj",)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jp)
    frozen = topt.freeze_by_prefix(("clipproj",))
    assert frozen("clipproj.proj") and not frozen("backbone.clip_proj.w")
    tp = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    opt, sched = topt.make_optimizer(
        tcfg.TrainConfig(**kw), [p for k, p in tp.items() if not frozen(k)],
        3)
    for step in range(2):
        g = {k: _rand(rng, *v.shape) for k, v in flat.items()}
        gtree = {"clipproj": {"proj": g["clipproj.proj"]},
                 "backbone": {"clip_proj": {"w": g["backbone.clip_proj.w"]}},
                 "ridge": {"w": g["ridge.w"]}}
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, gtree),
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.optimizer_step(opt, sched, step)
    np.testing.assert_array_equal(tp["clipproj.proj"].numpy(),
                                  tree["clipproj"]["proj"])
    assert rel_err(tp["backbone.clip_proj.w"],
                   jp["backbone"]["clip_proj"]["w"]) <= 1e-6
    assert rel_err(tp["ridge.w"], jp["ridge"]["w"]) <= 1e-6


# ----------------------------------------------------------- the step ----

@functools.lru_cache(maxsize=None)
def _params(seed=11):
    shapes = jax.eval_shape(JCore(BCFG).init, KEY,
                            jnp.zeros((2, 1, BCFG.voxel_counts[0])))
    return randomize(shapes["params"], seed)


def _port_core(params=None):
    core = NeuronsCore(port_cfg(tcfg.BrainModelConfig, BCFG))
    load_jax_params(core, _params() if params is None else params)
    return core


def _flat(params=None):
    return {n: p.detach().clone()
            for n, p in _port_core(params).named_parameters()}


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, 1, BCFG.voxel_counts[0]),
            _rand(rng, B, BCFG.clip_seq_dim, BCFG.clip_emb_dim),
            _rand(rng, B, BCFG.clip_txt_emb_dim))


STEP_KEY = jax.random.PRNGKey(9)


def _train_cfgs(bf16):
    j = jcfg.TrainConfig(batch_size=B, num_epochs=4, max_lr=0.01,
                         bf16_autocast=bf16)
    return j, port_cfg(tcfg.TrainConfig, j)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(bf16):
    """(metrics, grads) of JAX's stage1_loss (run only under
    `no_jax_dropout`)."""
    model = JCore(BCFG)
    params = jax.tree_util.tree_map(jnp.asarray, _params())

    @jax.jit
    def run(params, voxel, target, text):
        return jax.value_and_grad(lambda p: jtb.stage1_loss(
            model, p, STEP_KEY, voxel, target, text, 0.006, True, bf16),
            has_aux=True)(params)

    (_, metrics), grads = run(params, *map(jnp.asarray, _batch()))
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stage1_loss_and_grads_match_jax(no_jax_dropout, bf16):
    want, jgrads = _jax_loss_and_grads(bf16)
    core = _port_core()
    params = dict(core.named_parameters())
    loss, metrics = ttb.stage1_loss(core, params, jax_step_draws(STEP_KEY, B),
                                    *map(t, _batch()), 0.006, True, bf16)
    tol = 2e-2 if bf16 else 1e-5
    for k in ("loss", "loss_clip_vision", "loss_clip_txt"):
        assert rel_err(metrics[k], want[k]) <= tol, k
    names = list(params)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    want_g = _flat(jgrads)
    # f32: each tensor within 1e-4 of max(its largest JAX gradient, 1e-3 x
    # the model's largest), the floor for gradients that are rounding
    # noise on both sides; bf16: 5e-2 of the tensor's largest. With
    # seq_len 1 the mix1 path of each block feeds only a LayerNorm over one
    # element (whose output is its bias), so its gradients vanish in exact
    # arithmetic: JAX gives exact zeros, the port's LayerNorm backward
    # rounding noise scaled by its 1 / sqrt(eps) = 1000, held to 1e-4 of the
    # model's largest gradient
    top = max(want_g[n].abs().max() for n in names)
    dead = [n for n in names if not want_g[n].any()]
    assert dead and all(".mix1_" in n or ".mix2_ln_" in n for n in dead)
    for n, g in zip(names, grads):
        ref = want_g[n]
        scale = ref.abs().max()
        err = (g - ref).abs().max()
        if n in dead:
            assert err <= 1e-4 * top, n
        elif bf16:
            assert err <= 5e-2 * scale, n
        else:
            assert err <= 1e-4 * max(scale, 1e-3 * top), n


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_train_step_matches_jax(no_jax_dropout, bf16):
    """One update against JAX's masked AdamW: where the gradient is at
    least 1e-2 of its tensor's largest, the update within 1e-3 x lr (f32)
    or 5e-2 x lr (bf16); every element within Adam's bound lr; the frozen
    clipproj bitwise unchanged."""
    jt, tt = _train_cfgs(bf16)
    model, jstate, tx = jtb.init_stage1(BCFG, jt, 2, KEY)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    jstate = jstate._replace(params=params, opt_state=tx.init(params))
    jstate, jmetrics = jtb.make_stage1_train_step(model, tx, jt)(
        jstate, STEP_KEY, *map(jnp.asarray, _batch()))

    core, state, schedule = ttb.init_stage1(
        port_cfg(tcfg.BrainModelConfig, BCFG), tt, 2, device="cpu")
    load_jax_params(core, _params())
    old = _flat()
    state, metrics = ttb.make_stage1_train_step(core, schedule, tt)(
        state, jax_step_draws(STEP_KEY, B), *map(t, _batch()))
    assert state.step == 1
    for k in ("loss", "loss_clip_vision", "loss_clip_txt"):
        assert rel_err(metrics[k], float(jmetrics[k])) <= (
            2e-2 if bf16 else 1e-5), k
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    lr = schedule(0)
    for n, p in state.params.items():
        if n.startswith("clipproj."):
            assert torch.equal(p, old[n]) and torch.equal(want[n], old[n])
            continue
        got, ref = p.detach() - old[n], want[n] - old[n]
        if not ref.any():  # a gradient that vanishes (the mix1 path)
            assert ".mix1_" in n or ".mix2_ln_" in n, n
            assert got.abs().max() <= lr * (1 + 1e-3), n
            continue
        g = p.grad.abs()
        sharp = g >= max(1e-2 * g.max(), 1e-6)
        assert sharp.float().mean() > 0.5, n
        tol = (5e-2 if bf16 else 1e-3) * lr
        assert (got - ref).abs()[sharp].max() <= tol, n
        assert max(got.abs().max(), ref.abs().max()) <= lr * (1 + 1e-3), n


def test_eval_step_matches_jax():
    voxel, target, text = _batch(6)
    # the model's own outputs as targets, rows 0-3 swapped in pairs: the
    # retrieval hits half the rows
    _, vision, ctext = JCore(BCFG).apply({"params": _params()},
                                         jnp.asarray(voxel))
    swap = np.array([1, 0, 3, 2, 4, 5, 6, 7])
    rng = np.random.default_rng(7)
    target = np.asarray(vision)[swap] + 0.01 * _rand(rng, *target.shape)
    text = np.asarray(ctext)[swap] + 0.01 * _rand(rng, *text.shape)
    want = jtb.make_stage1_eval_step(JCore(BCFG))(
        _params(), *map(jnp.asarray, (voxel, target, text)))
    core = _port_core()
    got = ttb.make_stage1_eval_step(core)(dict(core.named_parameters()),
                                          *map(t, (voxel, target, text)))
    for k, v in want.items():
        assert float(got[k]) == float(v), k
    for k in ("test_fwd_percent_correct", "test_bwd_percent_correct"):
        assert float(got[k]) == 0.5, k


# ------------------------------------------------------------ the loop ----

def _splits():
    kw = dict(seq=BCFG.clip_seq_dim, emb=BCFG.clip_emb_dim,
              txt_dim=BCFG.clip_txt_emb_dim, n_frames=4)
    nv = BCFG.voxel_counts[0]
    train, table, _ = tcc.structured_synthetic_split(2 * B, nv, **kw)
    test, test_table, _ = tcc.structured_synthetic_split(
        B, nv, seed=1, train=False, **kw)
    return train, test, table, test_table


class Recorder:
    """MetricLogger's interface, recording."""

    def __init__(self):
        self.rows = []

    def log_metrics(self, metrics, step=None):
        self.rows.append({k: float(v) for k, v in metrics.items()})

    def log_images(self, images, step=None):
        pass


def _record_saves(monkeypatch, module):
    """Patch `module.save_ckpt` to record (tag, epoch, extra) and write
    nothing."""
    saves = []

    def save(directory, tag, *, params, opt_state=None, step=0, epoch=0,
             extra=None):
        saves.append((tag, int(epoch), {k: float(np.asarray(v)) for k, v in
                                        (extra or {}).items()}))

    monkeypatch.setattr(module, "save_ckpt", save)
    return saves


def _run_both(monkeypatch, tmp_path, num_epochs, best_save_every,
              max_lr=1e-3, seed=3):
    jt = jcfg.TrainConfig(batch_size=B, num_epochs=num_epochs, max_lr=max_lr,
                          bf16_autocast=False, seed=seed)
    tt = port_cfg(tcfg.TrainConfig, jt)
    train, test, table, test_table = _splits()
    jsaves = _record_saves(monkeypatch, jckpt)
    tsaves = _record_saves(monkeypatch, tckpt)
    jlog, tlog = Recorder(), Recorder()
    jsplit = jcc.CC2017Split(**dataclasses.asdict(train))
    jtest = jcc.CC2017Split(**dataclasses.asdict(test))
    jstate = jloop.run_stage1(
        BCFG, jt, create_mesh(MeshConfig(data=-1)), jsplit, jtest, table,
        test_table, ckpt_dir=str(tmp_path / "jax"), logger=jlog,
        warm_start_params=_params(), best_save_every=best_save_every)
    key = root_key(jt.seed)
    tstate = tloop.run_stage1(
        port_cfg(tcfg.BrainModelConfig, BCFG), tt, train, test, table,
        test_table, ckpt_dir=str(tmp_path / "port"), logger=tlog,
        warm_start_params=_flat(), best_save_every=best_save_every,
        draws=lambda epoch, it, b: jax_step_draws(
            epoch_key(key, epoch, it), B), device="cpu")
    return jstate, tstate, jlog.rows, tlog.rows, jsaves, tsaves, tt


def test_run_stage1_matches_jax(no_jax_dropout, monkeypatch, tmp_path):
    jstate, tstate, jrows, trows, jsaves, tsaves, tt = _run_both(
        monkeypatch, tmp_path, 2, 1)
    assert len(trows) == len(jrows) == 2
    for j, p in zip(jrows, trows):
        assert abs(p["train/mean_loss"] - j["train/mean_loss"]) <= 1e-4 * abs(
            j["train/mean_loss"])
        for k in ("test/fwd_pct", "test/bwd_pct", "test/text_pct"):
            assert p[k] == j[k], k
    assert [s[:2] for s in tsaves] == [s[:2] for s in jsaves]
    assert [s[0] for s in tsaves][-1] == "brain_model_last"
    for (_, _, pe), (_, _, je) in zip(tsaves, jsaves):
        assert pe == je
    assert tstate.step == int(jstate.step) == 4
    want = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    init = _flat()
    schedule = topt.make_lr_schedule(tt, 2)
    lr_sum = sum(schedule(i) for i in range(4))
    for n, p in tstate.params.items():
        err = (p.detach() - want[n]).abs().max()
        if torch.equal(want[n], init[n]):  # frozen, or a vanishing gradient
            assert n.startswith("clipproj.") or ".mix1_" in n \
                or ".mix2_ln_" in n, n
            assert err <= lr_sum * (1 + 1e-3), n
        else:
            # an element whose gradient is noise (of the mix1 path) may
            # take Adam's first steps the other way round
            far = ((p.detach() - want[n]).abs() > 1e-2 * lr_sum).float()
            assert far.mean() <= 1e-4, n
            assert err <= 2 * lr_sum, n


def test_run_stage1_best_save_throttle_matches_jax(no_jax_dropout,
                                                   monkeypatch, tmp_path):
    """best_save_every=2 over 4 epochs: the deferred saves, the flush at
    the last epoch and their extras, as JAX writes them."""
    _, _, jrows, trows, jsaves, tsaves, _ = _run_both(
        monkeypatch, tmp_path, 4, 2, max_lr=3e-3, seed=6)
    for j, p in zip(jrows, trows):
        for k in ("test/fwd_pct", "test/bwd_pct", "test/text_pct"):
            assert p[k] == j[k], k
    assert tsaves == jsaves
    # this seed improves at epoch 1 (deferred) and not at epoch 2, which
    # then writes its own params under epoch 1's watermark
    tag, epoch, extra = tsaves[1]
    assert (tag, epoch, extra["best_epoch"]) == ("brain_model", 2, 1)
    assert extra["save_epoch_metric"] < extra["best_metric"]


def test_stage1_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(tcfg.BrainModelConfig, BCFG)
    tt = tcfg.TrainConfig(batch_size=B, num_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttb.init_stage1(cfg, tt, 2)
    train, test, table, test_table = _splits()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.run_stage1(cfg, tt, train, test, table, test_table)
