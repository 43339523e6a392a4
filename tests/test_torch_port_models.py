"""Each ported module against its JAX counterpart at the tiny configs.

JAX parameters are initialised, every leaf is overwritten with seeded
random values (torch_port_utils.randomize), and the same leaves are carried
into the port with `load_jax_params`. Inputs come from numpy; both sides run
f32 on the CPU. Tolerance: max |port - JAX| <= 1e-4 * max |JAX|; token ids
and argmaxes are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.models import gpt2 as jgpt2
from neurons_tpu.models import prior as jprior
from neurons_tpu.models import unet2d as junet
from neurons_tpu.models.neurons import NeuronsDecoupler as JDecoupler
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import prior as tprior
from neurons_tpu_torch.models import unet2d as tunet
from neurons_tpu_torch.models.gpt2 import GPT2Config
from neurons_tpu_torch.models.neurons import NeuronsDecoupler
from neurons_tpu_torch.models.vae import AutoencoderKL
from torch_port_utils import randomize, rel_err, t

TOL = 1e-4


def port_cfg(cls, jax_cfg):
    """The port's config dataclass with the JAX config's field values."""
    import dataclasses
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def decoupler_pair():
    cfg = jcfg.tiny_pipeline_config()
    gcfg = jgpt2.tiny_gpt2_config()
    jmod = JDecoupler(cfg.brain, cfg.prior, cfg.decoupler, gcfg)
    voxel0 = jnp.zeros((1, 1, cfg.brain.voxel_counts[0]))
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), voxel0,
                            jnp.zeros((1, 8), jnp.int32))["params"]
    params = randomize(params, seed=1)
    tmod = NeuronsDecoupler(port_cfg(tcfg.BrainModelConfig, cfg.brain),
                            port_cfg(tcfg.PriorConfig, cfg.prior),
                            port_cfg(tcfg.DecouplerConfig, cfg.decoupler),
                            GPT2Config(*gcfg), device="cpu").eval()
    load_jax_params(tmod, params)

    def japply(method, *args, **kw):
        return jmod.apply({"params": params}, *args, method=method, **kw)

    return cfg, japply, tmod, params


def test_brain_encode(decoupler_pair):
    cfg, japply, tmod, _ = decoupler_pair
    voxel = np.random.default_rng(2).standard_normal(
        (2, 1, cfg.brain.voxel_counts[0]), dtype=np.float32)
    ref = japply(JDecoupler.encode, voxel)
    got = tmod.encode(t(voxel))
    for g, r in zip(got, ref):
        assert rel_err(g, r) <= TOL


def test_brain_heads(decoupler_pair):
    """MotionProj, CLIPProj and the classifier."""
    cfg, japply, tmod, _ = decoupler_pair
    c = cfg.brain
    x = np.random.default_rng(3).standard_normal(
        (2, c.clip_seq_dim, c.clip_emb_dim), dtype=np.float32)
    motion = japply(JDecoupler.motion, x)
    assert rel_err(tmod.motion(t(x)), motion) <= TOL
    pooled = np.asarray(motion).mean(axis=1)
    assert rel_err(tmod.project_text(t(pooled)),
                   japply(JDecoupler.project_text, pooled)) <= TOL
    logits = japply(JDecoupler.classify, pooled.mean(axis=1))
    got = tmod.classify(t(pooled.mean(axis=1)))
    assert rel_err(got, logits) <= TOL
    assert torch.equal(got.argmax(-1), t(np.asarray(logits).argmax(-1)))


def test_prior_with_hoisted_bias(decoupler_pair):
    cfg, japply, tmod, params = decoupler_pair
    c = cfg.prior
    rng = np.random.default_rng(4)
    img = rng.standard_normal((2, c.num_tokens, c.dim), dtype=np.float32)
    brain = rng.standard_normal((2, c.num_tokens, c.dim), dtype=np.float32)
    times = np.array([3, 0], np.int32)
    jbias = jprior.prior_attn_bias(params["prior_net"], c.num_tokens)
    tbias = tprior.prior_attn_bias(tmod.prior_net)
    assert rel_err(tbias, jbias) <= TOL
    ref = japply(JDecoupler.prior_apply, img, times, brain, attn_bias=jbias)
    got = tmod.prior_apply(t(img), t(times), t(brain), attn_bias=tbias)
    assert rel_err(got, ref) <= TOL
    # the bias computed inside the transformer gives the same result
    assert rel_err(tmod.prior_apply(t(img), t(times), t(brain)), ref) <= TOL


def test_prior_null_conditioning(decoupler_pair):
    cfg, japply, tmod, _ = decoupler_pair
    c = cfg.prior
    rng = np.random.default_rng(5)
    img = rng.standard_normal((1, c.num_tokens, c.dim), dtype=np.float32)
    times = np.array([1], np.int32)
    ref = japply(JDecoupler.prior_apply, img, times, img,
                 brain_cond_drop_prob=1.0, image_cond_drop_prob=1.0)
    got = tmod.prior_apply(t(img), t(times), t(img),
                           brain_cond_drop_prob=1.0, image_cond_drop_prob=1.0)
    assert rel_err(got, ref) <= TOL


@pytest.mark.parametrize("is_seg", [True, False], ids=["seg", "blurry"])
def test_decoder_video(decoupler_pair, is_seg):
    cfg, japply, tmod, _ = decoupler_pair
    b, f = 2, cfg.decoupler.n_frames
    rng = np.random.default_rng(6)
    vision = rng.standard_normal((b * f, cfg.brain.clip_seq_dim,
                                  cfg.brain.clip_emb_dim), dtype=np.float32)
    text = rng.standard_normal((b, cfg.brain.clip_txt_emb_dim),
                               dtype=np.float32)
    ref = japply(JDecoupler.seg_decode, vision, text, b * f, is_seg=is_seg)
    got = tmod.seg_decode(t(vision), t(text), b * f, is_seg=is_seg)
    assert got.shape == (b * f, 1 if is_seg else 4, 16, 16)
    assert rel_err(got, ref) <= TOL


def test_gpt2_greedy_tokens(decoupler_pair):
    cfg, japply, tmod, _ = decoupler_pair
    feats = np.random.default_rng(7).standard_normal(
        (3, cfg.brain.clip_txt_emb_dim), dtype=np.float32)
    ref = japply(JDecoupler.caption_greedy, feats, 8)
    got = tmod.caption_greedy(t(feats), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    tokens = np.asarray(ref)
    logits = japply(JDecoupler.caption_logits, feats, tokens)
    assert rel_err(tmod.caption_logits(t(feats), t(tokens)), logits) <= TOL


@pytest.fixture(scope="module")
def unet_pair():
    cfg = jcfg.tiny_pipeline_config().unet2d
    jmod = junet.UNetModel(cfg)
    x0 = jnp.zeros((2, 4, 8, 8))
    ctx0 = jnp.zeros((2, 6, cfg.context_dim))
    y0 = jnp.zeros((2, cfg.adm_in_channels))
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x0,
                            jnp.zeros((2,)), ctx0, y0)["params"]
    params = randomize(params, seed=11)
    tmod = tunet.UNetModel(port_cfg(tcfg.UNet2DConfig, cfg),
                           device="cpu").eval()
    load_jax_params(tmod, params)
    return cfg, jmod, params, tmod


@pytest.mark.parametrize("hoist_kv", [False, True], ids=["ctx", "ctx_kv"])
def test_unet2d(unet_pair, hoist_kv):
    cfg, jmod, params, tmod = unet_pair
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 4, 8, 8), dtype=np.float32)
    ts = np.array([3.0, 917.0], np.float32)
    ctx = rng.standard_normal((2, 6, cfg.context_dim), dtype=np.float32)
    y = rng.standard_normal((2, cfg.adm_in_channels), dtype=np.float32)
    kw_j, kw_t = {}, {}
    if hoist_kv:
        kv = junet.precompute_context_kv(params, jnp.asarray(ctx), cfg)
        kv_t = tunet.precompute_context_kv(tmod, t(ctx))
        for name, (k, v) in kv.items():
            assert rel_err(kv_t[name][0], k) <= TOL
            assert rel_err(kv_t[name][1], v) <= TOL
        kw_j, kw_t = {"ctx_kv": kv}, {"ctx_kv": kv_t}
    ref = jmod.apply({"params": params}, x, ts, ctx, y, **kw_j)
    with torch.no_grad():
        got = tmod(t(x), t(ts), t(ctx), t(y), **kw_t)
    assert rel_err(got, ref) <= TOL


def test_timestep_embedding():
    ts = np.array([0.0, 1.5, 999.0], np.float32)
    assert rel_err(tunet.timestep_embedding(t(ts), 17),
                   junet.timestep_embedding(ts, 17)) <= TOL


@pytest.fixture(scope="module")
def vae_pair():
    cfg = jcfg.tiny_pipeline_config().vae
    jmod = JVAE(cfg)
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 3, 16, 16)))["params"]
    params = randomize(params, seed=21)
    tmod = AutoencoderKL(port_cfg(tcfg.VAEConfig, cfg), device="cpu").eval()
    load_jax_params(tmod, params)
    return jmod, params, tmod


def test_vae_decode(vae_pair):
    jmod, params, tmod = vae_pair
    z = np.random.default_rng(22).standard_normal((2, 4, 8, 8),
                                                  dtype=np.float32)
    ref = jmod.apply({"params": params}, z, method=JVAE.decode)
    with torch.no_grad():
        got = tmod.decode(t(z))
    assert got.shape == (2, 3, 16, 16)
    assert rel_err(got, ref) <= TOL


def test_vae_encode(vae_pair):
    jmod, params, tmod = vae_pair
    x = np.random.default_rng(23).uniform(-1, 1, (2, 3, 16, 16)).astype(
        np.float32)
    ref = jmod.apply({"params": params}, x, method=JVAE.encode)
    with torch.no_grad():
        got = tmod.encode(t(x))
    assert rel_err(got.mean, ref.mean) <= TOL
    assert rel_err(got.logvar, ref.logvar) <= TOL
