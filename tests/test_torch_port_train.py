"""Stage-2 training, port against JAX package, on the CPU at tiny sizes.

Ops: the plain flash forward (output and log-sum-exp) against the Pallas
forward kernels in interpret mode; `flash_attention_bwd_reference` against
the Pallas backward kernels in interpret mode and against `jax.grad` of
`xla_attention`; the port's autograd Function against autograd of
`attention_reference`. Training pieces: every ported loss, the curriculum,
the three LR schedules and AdamW (with and without clipping) against
optax, `p_losses` with JAX's draws, the decoder's dropout masks. The slice:
`stage2_loss` terms and gradients in f32, one `make_stage2_train_step`,
the bf16-autocast loss, and a short `run_stage2`.

JAX PRNG and torch RNG never agree, so the tests rebuild JAX's draws from
its key splits (train_decoupler.py:122, diffusion/prior.py:51-58,
models/prior.py:322-329) and pass them to the port. Decoder dropout is off
on both sides in the slice tests: the JAX side through a test-local patch
of flax's Dropout (checked to take), the port's by passing no masks.

Tolerances (relative to max |JAX| unless stated): forward and lse 1e-5;
backward 2e-4 (as tests/test_attention.py); losses 1e-6; LR tables and
one AdamW update 1e-6; p_losses 1e-5; slice loss terms 1e-5, gradients
1e-4 (with a floor, see the test), parameters after one step 1e-5; the
bf16 loss terms 2e-2 (bf16 keeps
8 bits, about 4e-3 relative per rounding, and the two frameworks round at
other places).
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
from neurons_tpu.diffusion.prior import PriorDiffusion as JPriorDiffusion
from neurons_tpu.diffusion.prior import p_losses as jp_losses
from neurons_tpu.models import gpt2 as jgpt2
from neurons_tpu.models.decoder_video import TextDrivenDecoder as JTDD
from neurons_tpu.models.neurons import NeuronsDecoupler as JDecoupler
from neurons_tpu.ops import attention as jattn
from neurons_tpu.training import curriculum as jcurr
from neurons_tpu.training import losses as jlosses
from neurons_tpu.training import optimizers as jopt
from neurons_tpu.training import train_decoupler as jtd
from neurons_tpu.training.train_brain import TrainState as JTrainState
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.data import cc2017 as tcc
from neurons_tpu_torch.diffusion.prior import PriorDiffusion, PriorDraws
from neurons_tpu_torch.diffusion.prior import p_losses as tp_losses
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import decoder_video as tdv
from neurons_tpu_torch.models.gpt2 import GPT2Config
from neurons_tpu_torch.models.neurons import NeuronsDecoupler
from neurons_tpu_torch.ops import attention as tattn
from neurons_tpu_torch.training import curriculum as tcurr
from neurons_tpu_torch.training import loop as tloop
from neurons_tpu_torch.training import losses as tlosses
from neurons_tpu_torch.training import optimizers as topt
from neurons_tpu_torch.training import train_decoupler as ttd
from torch_port_utils import randomize, rel_err, t

KEY = jax.random.PRNGKey(0)


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


# ---------------------------------------------------------------- ops ----

# (b, h, tq, tk, d, kv heads, bias shape or None)
FWD_CASES = {
    "bias_hqk_mq": (1, 2, 130, 131, 16, 1, (2, 130, 131)),
    "bias_qk": (2, 2, 130, 140, 8, 2, (130, 140)),
    "bias_bhqk": (2, 2, 129, 130, 8, 2, (2, 2, 129, 130)),
    "nobias_smallkv": (1, 2, 130, 200, 32, 2, None),
    "nobias_streaming": (1, 1, 128, 1300, 32, 1, None),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_plain_forward_and_lse_match_pallas_interpret(case):
    b, h, tq, tk, d, hkv, bshape = FWD_CASES[case]
    rng = np.random.default_rng(1)
    q, k, v = _rand(rng, b, h, tq, d), _rand(rng, b, hkv, tk, d), \
        _rand(rng, b, hkv, tk, d)
    bias = _rand(rng, *bshape) if bshape else None
    out, lse = jattn._flash_attention_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), interpret=True,
        return_lse=True)
    assert lse is not None  # the kernel path, not the XLA fallback
    # the port's wrapper on CPU tensors computes the plain version
    got_out, got_lse = tattn.flash_attention_fwd(
        t(q), t(k), t(v), bias=None if bias is None else t(bias),
        return_lse=True)
    assert rel_err(got_out, out) <= 1e-5
    assert rel_err(got_lse, lse) <= 1e-5


BWD_TOL = 2e-4
# bias shapes qk / hqk / bhqk, multi-query, the prior's ragged 513 x 514
# at d = 52, and the unbiased kernel
BWD_CASES = {
    "qk": (3, 2, 160, 140, 16, 2, "qk"),
    "hqk_mq": (2, 4, 130, 140, 16, 1, "hqk"),
    "bhqk": (2, 2, 160, 140, 16, 2, "bhqk"),
    "ragged_513x514_d52": (2, 4, 513, 514, 52, 1, "hqk"),
    "nobias": (1, 2, 160, 192, 16, 2, None),
    "nobias_mq": (1, 2, 130, 150, 32, 1, None),
    # the VAE's head dim (the f32 TF32 column-split route past d 128)
    "nobias_d512": (2, 1, 130, 140, 512, 1, None),
}


def _bwd_inputs(case, seed=2):
    b, h, tq, tk, d, hkv, bkind = BWD_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v = _rand(rng, b, h, tq, d), _rand(rng, b, hkv, tk, d), \
        _rand(rng, b, hkv, tk, d)
    bias = None
    if bkind:
        bias = _rand(rng, *{"qk": (tq, tk), "hqk": (h, tq, tk),
                            "bhqk": (b, h, tq, tk)}[bkind])
    g = _rand(rng, b, h, tq, d)
    return q, k, v, bias, g


def _plain_bwd(q, k, v, bias, g):
    tb = None if bias is None else t(bias)
    out, lse = tattn.attention_reference_lse(t(q), t(k), t(v), tb)
    scale = q.shape[-1] ** -0.5
    return out, lse, tattn.flash_attention_bwd(t(q), t(k), t(v), tb, t(g),
                                               out, lse, scale)


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_pallas_interpret(case):
    q, k, v, bias, g = _bwd_inputs(case)
    out, lse, got = _plain_bwd(q, k, v, bias, g)
    scale = q.shape[-1] ** -0.5
    args = [jnp.asarray(x) for x in (q, k, v)]
    if bias is None:
        if k.shape[1] != q.shape[1]:  # the JAX caller broadcasts, then sums
            args[1:] = [jnp.broadcast_to(x, q.shape[:2] + x.shape[2:])
                        for x in args[1:]]
        want = jattn._flash_bwd_pallas(*args, jnp.asarray(g),
                                       jnp.asarray(out.numpy()),
                                       jnp.asarray(lse.numpy()), scale, True)
        want = list(want) + [None]
        if k.shape[1] != q.shape[1]:
            want[1:3] = [w.sum(axis=1, keepdims=True) for w in want[1:3]]
    else:
        want = jattn._flash_bwd_pallas_bias(
            *args, jnp.asarray(bias), jnp.asarray(g),
            jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()), scale, True)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        assert rel_err(a, w) <= BWD_TOL, name


# bf16 on both sides: the per-head multi-query bias, the prior's ragged
# 513 x 514 rows at d = 52, and the unbiased kernel. Both round g, p and
# ds*scale to bf16 at the same places, accumulate in f32 and round the
# outputs to bf16 (dbias to the bias's bf16); they differ only in f32
# summation order, which can move an output by one bf16 rounding step:
# BF16_BWD_TOL = 2^-8 relative to max |JAX|, that step at the largest
# element.
BF16_BWD_CASES = ("hqk_mq", "ragged_513x514_d52", "nobias")
BF16_BWD_TOL = 2.0 ** -8


@pytest.mark.parametrize("case", BF16_BWD_CASES)
def test_plain_backward_bf16_matches_pallas_interpret(case):
    bf16 = torch.bfloat16
    q, k, v, bias, g = (None if x is None else t(x).to(bf16)
                        for x in _bwd_inputs(case))
    scale = q.shape[-1] ** -0.5
    out, lse = tattn.attention_reference_lse(q, k, v, bias, scale)
    assert out.dtype == bf16 and lse.dtype == torch.float32
    # the port's wrapper on CPU tensors computes the plain backward
    got = tattn.flash_attention_bwd(q, k, v, bias, g, out, lse, scale)

    def j(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    args = [j(x) for x in (q, k, v)]
    rest = (j(g), j(out), jnp.asarray(lse.numpy()), scale, True)
    if bias is None:
        assert k.shape[1] == q.shape[1]
        want = list(jattn._flash_bwd_pallas(*args, *rest)) + [None]
    else:
        want = jattn._flash_bwd_pallas_bias(*args, j(bias), *rest)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        assert a.dtype == bf16 and w.dtype == jnp.bfloat16, name
        assert rel_err(a.float(), np.asarray(w, np.float32)) <= BF16_BWD_TOL, \
            name


# the plain version at the precision of the kernels' f32 route (every
# product's operands rounded to TF32) against the Pallas backward in
# interpret mode (f32): the unbiased cases, and the biased ones (a shared,
# a per-head over multi-query k/v, a per-(b, h) slice, the prior's ragged
# 513 x 514 at d = 52) against the biased kernel, dbias too; TF32 keeps
# 10 mantissa bits
@pytest.mark.parametrize("case", ["nobias", "nobias_mq", "nobias_d512", "qk",
                                  "hqk_mq", "bhqk", "ragged_513x514_d52"])
def test_plain_tf32_backward_matches_pallas_interpret(case):
    q, k, v, bias, g = _bwd_inputs(case)
    tq_, tk_, tv_ = t(q), t(k), t(v)
    tb = None if bias is None else t(bias)
    out, lse = tattn.attention_reference_tf32(tq_, tk_, tv_, bias=tb,
                                              return_lse=True)
    scale = q.shape[-1] ** -0.5
    got = tattn.flash_attention_bwd_reference(tq_, tk_, tv_, tb, t(g), out,
                                              lse, scale, tf32=True)
    args = [jnp.asarray(x) for x in (q, k, v)]
    rest = (jnp.asarray(g), jnp.asarray(out.numpy()),
            jnp.asarray(lse.numpy()), scale, True)
    if bias is not None:
        want = jattn._flash_bwd_pallas_bias(*args, jnp.asarray(bias), *rest)
    else:
        if k.shape[1] != q.shape[1]:  # the JAX caller broadcasts, then sums
            args[1:] = [jnp.broadcast_to(x, q.shape[:2] + x.shape[2:])
                        for x in args[1:]]
        want = list(jattn._flash_bwd_pallas(*args, *rest)) + [None]
        if k.shape[1] != q.shape[1]:
            want[1:3] = [w.sum(axis=1, keepdims=True) for w in want[1:3]]
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        assert a.dtype == torch.float32, name
        assert rel_err(a, w) <= 2.0 ** -8, name


@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_plain_backward_matches_jax_grad(case):
    q, k, v, bias, g = _bwd_inputs(case, seed=3)
    _, _, got = _plain_bwd(q, k, v, bias, g)
    wrt = (0, 1, 2) if bias is None else (0, 1, 2, 3)

    def f(q, k, v, bias):
        return jnp.sum(jattn.xla_attention(q, k, v, bias=bias) * g)

    want = jax.grad(f, argnums=wrt)(q, k, v, bias)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert rel_err(a, w) <= BWD_TOL, name


def test_autograd_function_matches_reference_autograd():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(_rand(rng, *s)).requires_grad_()
               for s in ((2, 4, 129, 16), (2, 1, 130, 16), (2, 1, 130, 16)))
    bias = torch.from_numpy(_rand(rng, 4, 129, 130)).requires_grad_()
    g = torch.from_numpy(_rand(rng, 2, 4, 129, 16))
    ins = (q, k, v, bias)
    want = torch.autograd.grad(tattn.attention_reference(*ins), ins, g)
    # the dispatcher takes the Function under autograd (biased multi-query)
    got = torch.autograd.grad(tattn.dot_product_attention(*ins), ins, g)
    for a, w in zip(got, want):
        assert rel_err(a, w.numpy()) <= 1e-5


# ---------------------------------------------------- training pieces ----

def test_losses_match_jax():
    rng = np.random.default_rng(5)
    a, b_ = _rand(rng, 6, 10), _rand(rng, 6, 10)
    an, bn = (np.asarray(jlosses.l2norm(x)) for x in (a, b_))
    assert rel_err(tlosses.l2norm(t(a)), an) <= 1e-6
    pairs = [
        (tlosses.mixco_nce(t(an), t(bn)), jlosses.mixco_nce(an, bn)),
        (tlosses.soft_clip_loss(t(an), t(bn), temp=0.05),
         jlosses.soft_clip_loss(an, bn, temp=0.05)),
    ]
    logits, mask = _rand(rng, 4, 1, 8, 8), (rng.random((4, 1, 8, 8)) < 0.3
                                            ).astype(np.float32)
    pairs.append((tlosses.dice_loss(t(logits), t(mask)),
                  jlosses.dice_loss(logits, mask)))
    cls, lab = _rand(rng, 4, 7), (rng.random((4, 7)) < 0.3).astype(np.float32)
    pairs.append((tlosses.bce_with_logits(t(cls), t(lab)),
                  jlosses.bce_with_logits(cls, lab)))
    tok_logits = _rand(rng, 3, 11, 50)
    tokens = rng.integers(0, 50, (3, 11)).astype(np.int32)
    tokens[:, -3:] = 0  # ignored padding
    pairs.append((tlosses.cross_entropy_ignore(t(tok_logits), t(tokens)),
                  jlosses.cross_entropy_ignore(tok_logits, tokens)))
    pairs.append((tlosses.l1_loss(t(a), t(b_)), jlosses.l1_loss(a, b_)))
    for got, want in pairs:
        assert rel_err(got, want) <= 1e-6
    for steps in (1, 2, 100):
        want = jlosses.cosine_anneal(0.004, 0.0075, steps)
        assert rel_err(tlosses.cosine_anneal(0.004, 0.0075, steps),
                       want) <= 1e-6


@pytest.mark.parametrize("num_epochs", [3, 20, 150])
def test_loss_weights_match_jax(num_epochs):
    spe = 7
    for epoch in range(0, num_epochs, max(1, num_epochs // 15)):
        for it in (0, 3, 6):
            want = jcurr.get_loss_weights(num_epochs, jnp.asarray(epoch),
                                          jnp.asarray(it), spe)
            got = tcurr.get_loss_weights(num_epochs, epoch, it, spe)
            assert rel_err(got, want) <= 1e-6, (epoch, it)


@pytest.mark.parametrize("kind", ["cycle", "linear", "cosine"])
@pytest.mark.parametrize("num_epochs", [3, 10])
def test_lr_schedule_matches_optax(kind, num_epochs):
    spe = 7
    cfg = jcfg.TrainConfig(num_epochs=num_epochs, lr_scheduler_type=kind)
    want = np.asarray(jax.vmap(jopt.make_lr_schedule(cfg, spe))(
        jnp.arange(num_epochs * spe + 3)))
    sched = topt.make_lr_schedule(
        tcfg.TrainConfig(num_epochs=num_epochs, lr_scheduler_type=kind), spe)
    got = np.array([sched(i) for i in range(len(want))])
    assert rel_err(got, want) <= 1e-6


@pytest.mark.parametrize("grad_clip", [0.0, 0.5])
def test_adamw_update_matches_optax(grad_clip):
    rng = np.random.default_rng(6)
    params = {"w": _rand(rng, 5, 3), "b": _rand(rng, 3)}
    grads = [{k: _rand(rng, *v.shape) for k, v in params.items()}
             for _ in range(2)]
    kw = dict(max_lr=0.05, weight_decay=0.01, grad_clip=grad_clip,
              num_epochs=10)
    tx, _ = jopt.make_optimizer(jcfg.TrainConfig(**kw), 7)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in params.items()}
    opt, sched = topt.make_optimizer(tcfg.TrainConfig(**kw), tp.values(), 7)
    for step, g in enumerate(grads):  # two updates: the moments carry over
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.optimizer_step(opt, sched, step, grad_clip)
        for k in params:
            assert rel_err(tp[k], jp[k]) <= 1e-6, (step, k)


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


# ---------------------------------------------------------- the slice ----

CFG = jcfg.tiny_pipeline_config()
GCFG = jgpt2.tiny_gpt2_config()
B, SOFT_TEMP, SPE = 4, 0.05, 4
STEP_KEY = jax.random.PRNGKey(4)  # drops rows of both conditions (checked)


def port_cfg(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


def _train_cfgs(bf16):
    j = jcfg.replace(CFG.train, bf16_autocast=bf16, max_lr=0.05)
    return j, port_cfg(tcfg.TrainConfig, j)


@functools.lru_cache(maxsize=None)
def _params(seed=41):
    jmod = JDecoupler(CFG.brain, CFG.prior, CFG.decoupler, GCFG)
    shapes = jax.eval_shape(jmod.init, KEY,
                            jnp.zeros((2, 1, CFG.brain.voxel_counts[0])),
                            jnp.zeros((2, 8), jnp.int32))["params"]
    return randomize(shapes, seed)


def _batch():
    rng = np.random.default_rng(42)
    c, d = CFG.brain, CFG.decoupler
    f, n, e = d.n_frames, c.clip_seq_dim, c.clip_emb_dim
    tokens = rng.integers(1, GCFG.vocab_size, (B, 12)).astype(np.int32)
    tokens[:, 9:] = 0
    return {
        "voxel": _rand(rng, B, 1, c.voxel_counts[0]),
        "clip_vision_target": _rand(rng, B, n, e),
        "clip_video_target": _rand(rng, B, f, n, e),
        "text_emb": _rand(rng, B, d.clip_txt_emb_dim),
        "key_obj_text_embed": _rand(rng, B, d.clip_txt_emb_dim),
        "key_obj_masks": (rng.random((B, f, 32, 32)) < 0.3).astype(np.float32),
        "cls_label": (rng.random((B, d.num_classes)) < 0.3).astype(np.float32),
        "clip_tokens": tokens,
        "vae_latents": _rand(rng, B, f, 4, 8, 8),
    }


def _jax_bundle(jt):
    tx, _ = jopt.make_optimizer(jt, SPE,
                                frozen_fn=jopt.freeze_by_prefix(("core",)))
    return jtd.Stage2Bundle(JDecoupler(CFG.brain, CFG.prior, CFG.decoupler,
                                       GCFG),
                            JPriorDiffusion.create(CFG.prior.timesteps,
                                                   CFG.prior.cond_drop_prob),
                            tx)


def _port(tt):
    bundle, state = ttd.init_stage2(
        port_cfg(tcfg.BrainModelConfig, CFG.brain),
        port_cfg(tcfg.PriorConfig, CFG.prior),
        port_cfg(tcfg.DecouplerConfig, CFG.decoupler), tt, GPT2Config(*GCFG),
        SPE, device="cpu")
    load_jax_params(bundle.model, _params())
    return bundle, state


def _port_draws(key):
    k_prior = jax.random.split(key, 3)[1]
    shape = (B, CFG.brain.clip_seq_dim, CFG.brain.clip_emb_dim)
    return ttd.Stage2Draws(_jax_prior_draws(
        k_prior, shape, CFG.prior.timesteps, CFG.prior.cond_drop_prob), None)


@pytest.fixture()
def no_jax_dropout(monkeypatch):
    """flax's Dropout as the identity, for this test only."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, *a, **kw: inputs)


def test_dropout_patch_takes(no_jax_dropout):
    dec = JTDD(clip_vision_emb_dim=32, clip_txt_emb_dim=24,
               decoder_block_out_channels=(8, 8, 8))
    rng = np.random.default_rng(7)
    x, text = _rand(rng, 4, 16, 32), _rand(rng, 2, 24)
    params = randomize(jax.eval_shape(
        lambda key: dec.init(key, x, text, 4), KEY)["params"], 8)
    outs = [dec.apply({"params": params}, x, text, 4, deterministic=False,
                      rngs={"dropout": jax.random.PRNGKey(s)})
            for s in (1, 2)]
    np.testing.assert_array_equal(np.asarray(outs[0]), np.asarray(outs[1]))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    """JAX's stage2_loss terms and trainable gradients (f32, dropout off:
    run only under `no_jax_dropout`)."""
    jt, _ = _train_cfgs(False)
    bundle = _jax_bundle(jt)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    weights = jnp.asarray([1.5, 2.0, 3.0, 0.5])

    @jax.jit
    def run(params, batch):
        core = params["core"]
        trainable = {k: v for k, v in params.items() if k != "core"}

        def loss_fn(tp):
            return jtd.stage2_loss(bundle, dict(tp, core=core), STEP_KEY,
                                   batch, SOFT_TEMP, weights, jt,
                                   CFG.decoupler)

        return jax.value_and_grad(loss_fn, has_aux=True)(trainable)

    (_, metrics), grads = run(params, _batch())
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def test_draws_drop_rows_of_both_conditions():
    draws = _port_draws(STEP_KEY).prior
    assert not draws.brain_keep.all() and not draws.image_keep.all()
    assert draws.brain_keep.any() and draws.image_keep.any()


def test_stage2_loss_and_grads_match_jax(no_jax_dropout):
    want, jgrads = _jax_loss_and_grads()
    _, tt = _train_cfgs(False)
    bundle, state = _port(tt)
    batch = {k: t(v) for k, v in _batch().items()}
    loss, metrics = ttd.stage2_loss(
        bundle, state.params, _port_draws(STEP_KEY), batch, SOFT_TEMP,
        torch.tensor([1.5, 2.0, 3.0, 0.5]), tt, bundle_dcfg())
    for k in ttd.LOSS_TERMS + ("loss", "train_acc_text_gen"):
        assert rel_err(metrics[k], want[k]) <= 1e-5, k
    names = [n for n in state.params if not ttd.is_core(n)]
    grads = torch.autograd.grad(loss, [state.params[n] for n in names])
    # JAX's gradient tree in the port's layout, through the weight carrier
    gmod = NeuronsDecoupler(bundle.model.core.backbone.cfg,
                            bundle.model.prior_net.cfg, bundle_dcfg(),
                            GPT2Config(*GCFG), device="cpu")
    load_jax_params(gmod, dict(jgrads, core=_params()["core"]))
    want_g = {n: p.detach().numpy() for n, p in gmod.named_parameters()}
    # each tensor within 1e-4 of max(its largest JAX gradient, 1e-3 x the
    # model's largest): gradients that vanish in exact arithmetic (a bias
    # that a following normalisation removes, a key bias under softmax)
    # are f32 rounding noise of ~1e-9 on both sides
    floor = 1e-3 * max(np.abs(want_g[n]).max() for n in names)
    for n, g in zip(names, grads):
        err = np.abs(g.numpy() - want_g[n]).max()
        assert err <= 1e-4 * max(np.abs(want_g[n]).max(), floor), n


def bundle_dcfg():
    return port_cfg(tcfg.DecouplerConfig, CFG.decoupler)


def test_train_step_matches_jax(no_jax_dropout):
    """One update against JAX's. Adam's first step divides each gradient by
    its own magnitude, so an element whose gradient is rounding noise (zero
    in exact arithmetic) moves by +-lr in either framework at random: the
    update is held to 1e-3 * lr where the gradient is at least 1e-2 of its
    tensor's largest (and 1e-6), and every element's move to Adam's bound
    lr; the core stays bitwise."""
    jt, tt = _train_cfgs(False)
    bundle = _jax_bundle(jt)
    params = jax.tree_util.tree_map(jnp.asarray, _params())
    jstate = JTrainState(params, bundle.tx.init(params),
                         jnp.zeros((), jnp.int32))
    step = jtd.make_stage2_train_step(bundle, jt, CFG.decoupler, SPE)
    jbatch = {k: jnp.asarray(v) for k, v in _batch().items()}
    jstate, jmetrics = step(jstate, STEP_KEY, jbatch, jnp.asarray(1),
                            jnp.asarray(2), jnp.asarray(SOFT_TEMP))

    tbundle, tstate = _port(tt)
    tstep = ttd.make_stage2_train_step(tbundle, tt, bundle_dcfg(), SPE)
    batch = {k: t(v) for k, v in _batch().items()}
    tstate, metrics = tstep(tstate, _port_draws(STEP_KEY), batch, 1, 2,
                            SOFT_TEMP)
    assert tstate.step == 1
    for k in ttd.LOSS_TERMS + ("loss",):
        assert rel_err(metrics[k], float(jmetrics[k])) <= 1e-5, k
    gmod = NeuronsDecoupler(tbundle.model.core.backbone.cfg,
                            tbundle.model.prior_net.cfg, bundle_dcfg(),
                            GPT2Config(*GCFG), device="cpu")
    load_jax_params(gmod, jax.tree_util.tree_map(np.asarray, jstate.params))
    want = {n: p.detach().numpy() for n, p in gmod.named_parameters()}
    old = _flat_params()
    lr = tbundle.schedule(0)
    checked = 0
    for n, p in tstate.params.items():
        if ttd.is_core(n):
            assert np.array_equal(p.numpy(), old[n]), n
            continue
        got, ref = p.detach().numpy() - old[n], want[n] - old[n]
        g = np.abs(p.grad.numpy())
        sharp = g >= max(1e-2 * g.max(), 1e-6)
        assert np.all(np.abs(got - ref)[sharp] <= 1e-3 * lr), n
        checked += sharp.sum()
        # (up to the f32 rounding of p_new - p_old)
        assert max(np.abs(got).max(), np.abs(ref).max()) <= lr * (1 + 1e-3)
    assert checked > 0.5 * sum(p.numel() for n, p in tstate.params.items()
                               if not ttd.is_core(n))


@functools.lru_cache(maxsize=None)
def _flat_params():
    gmod = NeuronsDecoupler(port_cfg(tcfg.BrainModelConfig, CFG.brain),
                            port_cfg(tcfg.PriorConfig, CFG.prior),
                            bundle_dcfg(), GPT2Config(*GCFG), device="cpu")
    load_jax_params(gmod, _params())
    return {n: p.detach().numpy().copy() for n, p in gmod.named_parameters()}


def test_bf16_autocast_loss_matches_jax(no_jax_dropout):
    jt, tt = _train_cfgs(True)
    bundle = _jax_bundle(jt)
    weights = jnp.asarray([1.5, 2.0, 3.0, 0.5])
    loss_fn = jax.jit(lambda p, batch: jtd.stage2_loss(
        bundle, p, STEP_KEY, batch, SOFT_TEMP, weights, jt,
        CFG.decoupler)[1])
    want = loss_fn(jax.tree_util.tree_map(jnp.asarray, _params()), _batch())
    tbundle, tstate = _port(tt)
    batch = {k: t(v) for k, v in _batch().items()}
    with torch.no_grad():
        _, got = ttd.stage2_loss(tbundle, tstate.params,
                                 _port_draws(STEP_KEY), batch, SOFT_TEMP,
                                 torch.tensor([1.5, 2.0, 3.0, 0.5]), tt,
                                 bundle_dcfg())
    for k in ttd.LOSS_TERMS + ("loss",):
        assert rel_err(got[k], float(want[k])) <= 2e-2, k


def test_p_losses_matches_jax():
    params = _params()
    jmod = JDecoupler(CFG.brain, CFG.prior, CFG.decoupler, GCFG)
    diff = JPriorDiffusion.create(CFG.prior.timesteps, 0.5)
    rng = np.random.default_rng(9)
    shape = (B, CFG.brain.clip_seq_dim, CFG.brain.clip_emb_dim)
    target, brain = _rand(rng, *shape), _rand(rng, *shape)
    key = jax.random.PRNGKey(3)

    def net_apply(p, image_embed, times, brain_embed, **kw):
        return jmod.apply({"params": p}, image_embed, times, brain_embed,
                          method=JDecoupler.prior_apply, **kw)

    want_loss, want_pred = jax.jit(lambda p: jp_losses(
        diff, net_apply, p, key, target, brain))(params)
    model = _port(_train_cfgs(False)[1])[0].model
    draws = _jax_prior_draws(key, shape, CFG.prior.timesteps, 0.5)
    assert not draws.brain_keep.all() and draws.brain_keep.any()
    got_loss, got_pred = tp_losses(
        PriorDiffusion.create(CFG.prior.timesteps, 0.5), model.prior_apply,
        t(target), t(brain), draws=draws)
    assert rel_err(got_pred, want_pred) <= 1e-5
    assert rel_err(got_loss, want_loss) <= 1e-5


def test_dropout_masks_keep_fraction_scale_and_seed():
    def draw(seed):
        return tdv.draw_decoder_dropout(
            40, 64, 5, 96, torch.Generator().manual_seed(seed), "cpu")

    a, b_, c = draw(1), draw(1), draw(2)
    for name, rate in (("attn", 0.1), ("out", 0.1), ("maps", 0.3)):
        m = getattr(a, name)
        assert torch.equal(m, getattr(b_, name))
        assert not torch.equal(m, getattr(c, name))
        assert abs(m.float().mean().item() - (1 - rate)) < 0.01, name
    assert a.attn.shape == (40, 64, 5) and a.out.shape == (40, 64, 96)
    assert a.maps.shape == (40, 64, 8, 8)
    x = torch.randn(40, 64, 96)
    y = tdv.dropout(x, a.out, 0.1)
    assert torch.equal(y[a.out], x[a.out] / 0.9)
    assert not y[~a.out].any()


def test_run_stage2_short_run():
    cfg = tcfg.tiny_pipeline_config()
    g = GPT2Config(*GCFG)
    split = tcc.synthetic_split(n=16, n_voxels=cfg.brain.voxel_counts[0],
                                n_frames=cfg.decoupler.n_frames)
    builder = tloop.synthetic_stage2_batch_builder(cfg.brain, cfg.decoupler,
                                                   g.vocab_size)
    records = []

    class Logger:  # MetricLogger's interface
        def log_metrics(self, metrics, step=None):
            records.append((metrics, step))

        def log_images(self, images, step=None):
            pass

    state = tloop.run_stage2(cfg.brain, cfg.prior, cfg.decoupler, cfg.train,
                             g, split, builder, logger=Logger(),
                             bf16_frozen_core=True, device="cpu")
    spe = 16 // cfg.train.batch_size
    assert state.step == cfg.train.num_epochs * spe
    assert [s for _, s in records] == [spe, 2 * spe]
    for m, _ in records:
        for k in ttd.LOSS_TERMS:
            assert np.isfinite(m[f"train/mean_{k}"]), k
    fresh, _ = ttd.init_stage2(cfg.brain, cfg.prior, cfg.decoupler,
                               cfg.train, g, spe, seed=cfg.train.seed,
                               device="cpu")
    for n, p in fresh.model.named_parameters():
        if ttd.is_core(n):  # frozen, held in bf16
            assert state.params[n].dtype == torch.bfloat16
            assert torch.equal(state.params[n], p.to(torch.bfloat16)), n
    # the temporal branches start blended out (blend weight 1, which bf16
    # keeps at 1 under updates of lr ~1e-5), so their weights get zero
    # gradients; every other trainable tensor moves
    moved = [not torch.equal(state.params[n], p)
             for n, p in fresh.model.named_parameters()
             if not ttd.is_core(n) and ".temp_attn." not in n]
    assert all(moved)


def test_train_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.tiny_pipeline_config()
    g = GPT2Config(*GCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttd.init_stage2(cfg.brain, cfg.prior, cfg.decoupler, cfg.train, g, 4)
    split = tcc.synthetic_split(n=8, n_voxels=cfg.brain.voxel_counts[0],
                                n_frames=cfg.decoupler.n_frames)
    builder = tloop.synthetic_stage2_batch_builder(cfg.brain, cfg.decoupler,
                                                   g.vocab_size)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.run_stage2(cfg.brain, cfg.prior, cfg.decoupler, cfg.train, g,
                         split, builder)
