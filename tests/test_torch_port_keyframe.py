"""The whole stage-3 slice, port against JAX package, on the tiny config.

`reconstruct_keyframes` runs in base and enhance mode with 4 prior and 3
unCLIP steps. JAX PRNG and torch RNG never agree, so the test rebuilds the
JAX pipeline's draws from its own key splits (diffusion/prior.py:74-89,
pipelines/keyframe.py:94-106) and hands them to the port as `noise=`.
Tolerance: keyframes, blurry latents and prior tokens within
1e-3 * max |JAX| (four prior and three CFG-5 sampler steps compound the
f32 rounding of each module, which the per-module tests hold to 1e-4);
caption tokens and the classifier's argmax are equal."""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.models import gpt2 as jgpt2
from neurons_tpu.models.neurons import NeuronsDecoupler as JDecoupler
from neurons_tpu.models.unet2d import UNetModel as JUNet
from neurons_tpu.models.unet2d import precompute_context_kv as jkv
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu.pipelines import keyframe as jkf
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.diffusion.prior import PriorNoise
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models.gpt2 import GPT2Config
from neurons_tpu_torch.models.neurons import NeuronsDecoupler
from neurons_tpu_torch.models.unet2d import UNetModel
from neurons_tpu_torch.models.vae import AutoencoderKL
from neurons_tpu_torch.pipelines import keyframe as tkf
from torch_port_utils import randomize, rel_err, t

TOL = 1e-3
B, LAT, CAP = 2, 8, 8


def port_cfg(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


def slice_parts(dec_seed):
    """The tiny stage-3 models of both packages with the same weights (the
    decoupler's drawn at `dec_seed`), and the voxel and class-text inputs."""
    cfg = jcfg.tiny_pipeline_config()
    # the unclip vector is the 1024-d size/crop embedding
    ucfg = jcfg.replace(cfg.unet2d, adm_in_channels=1024)
    gcfg = jgpt2.tiny_gpt2_config()
    key = jax.random.PRNGKey(0)

    jdec = JDecoupler(cfg.brain, cfg.prior, cfg.decoupler, gcfg)
    dparams = randomize(jax.eval_shape(
        jdec.init, key, jnp.zeros((1, 1, cfg.brain.voxel_counts[0])),
        jnp.zeros((1, 8), jnp.int32))["params"], seed=dec_seed)
    junet = JUNet(ucfg)
    uparams = randomize(jax.eval_shape(
        junet.init, key, jnp.zeros((2, 4, LAT, LAT)), jnp.zeros((2,)),
        jnp.zeros((2, 6, ucfg.context_dim)),
        jnp.zeros((2, 1024)))["params"], seed=32)
    jvae = JVAE(cfg.vae)
    vparams = randomize(jax.eval_shape(
        jvae.init, key, jnp.zeros((1, 3, 16, 16)))["params"], seed=33)

    tdec = NeuronsDecoupler(port_cfg(tcfg.BrainModelConfig, cfg.brain),
                            port_cfg(tcfg.PriorConfig, cfg.prior),
                            port_cfg(tcfg.DecouplerConfig, cfg.decoupler),
                            GPT2Config(*gcfg), device="cpu").eval()
    load_jax_params(tdec, dparams)
    tunet = UNetModel(port_cfg(tcfg.UNet2DConfig, ucfg), device="cpu").eval()
    load_jax_params(tunet, uparams)
    tvae = AutoencoderKL(port_cfg(tcfg.VAEConfig, cfg.vae),
                         device="cpu").eval()
    load_jax_params(tvae, vparams)

    rng = np.random.default_rng(34)
    voxel = rng.standard_normal((B, 1, cfg.brain.voxel_counts[0]),
                                dtype=np.float32)
    class_embeds = rng.standard_normal(
        (cfg.decoupler.num_classes, cfg.decoupler.clip_txt_emb_dim),
        dtype=np.float32)
    return SimpleNamespace(
        cfg=cfg, ucfg=ucfg, key=key, jdec=jdec, dparams=dparams, junet=junet,
        uparams=uparams, jvae=jvae, vparams=vparams, tdec=tdec, tunet=tunet,
        tvae=tvae, voxel=voxel, class_embeds=class_embeds)


def jax_stage3(p, enhance=True, mask_latent_hw=None):
    """The JAX package's `reconstruct_keyframes` on `slice_parts` models."""
    def dec_apply(params, method, *a, **kw):
        return p.jdec.apply({"params": params}, *a, method=method, **kw)

    def unet_apply(params, x, tt, crossattn, vector, **kw):
        return p.junet.apply({"params": params}, x, tt, crossattn, vector,
                             **kw)

    def vae_decode(z):
        return p.jvae.apply({"params": p.vparams}, z, method=JVAE.decode)

    return jkf.reconstruct_keyframes(
        decoupler_apply=dec_apply, decoupler_params=p.dparams,
        unet_apply=unet_apply, unet_params=p.uparams,
        vae_decode=vae_decode, key=p.key, voxel=p.voxel,
        class_text_embeds=jnp.asarray(p.class_embeds),
        sampler_cfg=p.cfg.sampler,
        n_frames=p.cfg.decoupler.n_frames, latent_hw=LAT,
        enhance=enhance, caption_len=CAP, mask_latent_hw=mask_latent_hw,
        sampler_opts=dict(precompute_kv=lambda params, c: jkv(params, c,
                                                               p.ucfg)))


def build_slice(dec_seed):
    """(cfg, run_jax, run_port, port VAE, port decoupler, JAX decoupler,
    its params) with the decoupler's weights drawn at `dec_seed`."""
    p = slice_parts(dec_seed)
    cfg, key = p.cfg, p.key

    def run_jax(enhance, mask_latent_hw):
        return jax_stage3(p, enhance, mask_latent_hw)

    def run_port(enhance, mask_latent_hw, generator=None):
        noise = None if generator is not None else jax_draws(key, cfg)
        return tkf.reconstruct_keyframes(
            p.tdec, p.tunet, p.tvae, t(p.voxel),
            class_text_embeds=t(p.class_embeds),
            sampler_cfg=port_cfg(tcfg.SamplerConfig, cfg.sampler),
            latent_hw=LAT, enhance=enhance,
            caption_len=CAP, mask_latent_hw=mask_latent_hw,
            generator=generator, noise=noise, device="cpu")

    return cfg, run_jax, run_port, p.tvae, p.tdec, p.jdec, p.dparams


@pytest.fixture(scope="module")
def slice_pair():
    # The tiny decoder's temporal GroupNorm groups hold one channel over
    # four frames, so a nearly constant group can amplify f32 rounding by
    # orders of magnitude: at decoupler seed 31 the blurry latents miss the
    # 1e-3 tolerance (test_seed31_blurry_gap_is_conditioning shows why).
    # Seed 38 gives a well-conditioned instance;
    # test_slice_instance_is_well_conditioned holds it to that.
    return build_slice(38)[:5]


def jax_draws(key, cfg):
    """The JAX pipeline's random draws, rebuilt from its key splits."""
    c = cfg.brain
    k_prior, k_unclip = jax.random.split(key)
    k_init, k_loop = jax.random.split(k_prior)
    shape = (B, c.clip_seq_dim, c.clip_emb_dim)
    steps = [t(jax.random.normal(jax.random.fold_in(k_loop, i), shape))
             for i in range(cfg.sampler.prior_steps)]
    prior = PriorNoise(t(jax.random.normal(k_init, shape)), steps)
    k_z, k_noise, k_offset, k_uc = jax.random.split(k_unclip, 4)
    lat = (B, 4, LAT, LAT)
    unclip = tkf.UnclipNoise(t(jax.random.normal(k_z, lat)),
                             t(jax.random.normal(k_noise, lat)),
                             t(jax.random.normal(k_offset, (B,))),
                             t(jax.random.normal(k_uc, shape)))
    return tkf.KeyframeNoise(prior, unclip)


def _compare(ref, got):
    assert got.keyframes.shape == (B, 3, 16, 16)
    assert rel_err(got.prior_tokens, ref.prior_tokens) <= TOL
    assert rel_err(got.motion_embeds, ref.motion_embeds) <= TOL
    assert rel_err(got.blurry_latents, ref.blurry_latents) <= TOL
    assert rel_err(got.keyframes, ref.keyframes) <= TOL
    np.testing.assert_array_equal(got.captions.numpy(),
                                  np.asarray(ref.captions))


def test_reconstruct_keyframes_base(slice_pair):
    _, run_jax, run_port, _, _ = slice_pair
    ref, got = run_jax(False, None), run_port(False, None)
    _compare(ref, got)
    assert got.cls_logits is None and got.seg_masks is None


def test_reconstruct_keyframes_enhance(slice_pair):
    # mask_latent_hw=8 halves the 16x16 blurry latents, so the gate is
    # downsampled (16 -> 8) as is the frame-mean token mask (16 -> 4)
    _, run_jax, run_port, tvae, _ = slice_pair
    ref, got = run_jax(True, 8), run_port(True, 8)
    _compare(ref, got)
    assert got.blurry_latents.shape[-1] == 8
    assert rel_err(got.cls_logits, ref.cls_logits) <= TOL
    np.testing.assert_array_equal(got.cls_logits.argmax(-1).numpy(),
                                  np.asarray(ref.cls_logits).argmax(-1))
    assert rel_err(got.seg_masks, ref.seg_masks) <= TOL
    # the gate really was mixed: both {0.5, 1.0} levels appear
    gate = (torch.sigmoid(got.seg_masks) > 0.5)
    assert gate.any() and not gate.all()

    video = tkf.decode_blurry_video(tvae, got.blurry_latents, 2)
    assert video.shape == (B, 2, 3, 16, 16)
    assert torch.isfinite(video).all()
    assert video.min() >= 0 and video.max() <= 1


def test_reconstruct_keyframes_generator_draws(slice_pair):
    """Without explicit noise the draws come from the generator: the same
    seed gives the same outputs, another seed other keyframes."""
    _, _, run_port, _, _ = slice_pair
    a, b, c = (run_port(True, None, torch.Generator().manual_seed(seed))
               for seed in (5, 5, 6))
    for name in ("prior_tokens", "keyframes", "blurry_latents", "captions"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.isfinite(a.keyframes).all()
    assert not torch.equal(a.keyframes, c.keyframes)


def test_slice_instance_is_well_conditioned(slice_pair):
    """The premise of the 1e-3 slice tolerance: at these weights a 1e-6
    relative change of the pooled text moves the blurry and seg maps by
    under 1e-4 relative (a gain below 1e2), and no seg logit sits within
    1e-4 * max |seg| of the gate's threshold (0), beyond what f32 rounding
    times that gain can move it, so no gate flips between the ports."""
    _, _, run_port, _, tdec = slice_pair
    out = run_port(True, None)
    b, f = out.motion_embeds.shape[:2]
    flat = out.motion_embeds.reshape(b * f, *out.motion_embeds.shape[2:])
    with torch.no_grad():
        pooled = tdec.project_text(out.motion_embeds.mean(dim=1))
        for is_seg in (True, False):
            a = tdec.seg_decode(flat, pooled, b * f, is_seg=is_seg)
            a2 = tdec.seg_decode(flat, pooled * (1 + 1e-6), b * f,
                                 is_seg=is_seg)
            assert rel_err(a2, a.numpy()) < 1e-4
    seg = out.seg_masks.abs()
    assert seg.min() > 1e-4 * seg.max()


def test_seed31_blurry_gap_is_conditioning():
    """Why the slice's decoupler seed is not 31: there, one temporal
    GroupNorm group of the blurry head's mid block is nearly constant
    (max |x| / std > 1e3), so f32 rounding before it is amplified, and the
    blurry maps of the two packages differ by more than 1e-3 on the same
    input. The gap is the instance's, not the port's: the JAX package's
    own f32 result lies as far from its x64 result, both f32 results lie as
    far from the port's float64 result, and in float64 on both sides the
    gap closes (to what the JAX package still rounds to f32 under x64:
    GroupNorm statistics and attention logits)."""
    _, _, run_port, _, tdec, jdec, dparams = build_slice(31)
    motion = run_port(False, None).motion_embeds.numpy()
    b, f = motion.shape[:2]

    @jax.jit
    def jax_head_jit(params, m):
        pooled = jdec.apply({"params": params}, m.mean(1),
                            method=JDecoupler.project_text)
        return jdec.apply({"params": params}, m.reshape(b * f, *m.shape[2:]),
                          pooled, b * f, is_seg=False,
                          method=JDecoupler.seg_decode)

    def jax_head(params, dtype):
        return np.asarray(jax_head_jit(params, jnp.asarray(motion, dtype)),
                          np.float64)

    spread = []

    def spread_hook(mod, args, out):
        xg = args[0].reshape(args[0].shape[0], mod.num_groups, -1)
        spread.append((xg.abs().amax(-1) / xg.std(-1, unbiased=False))
                      .max().item())

    def port_head(mod, dtype):
        with torch.no_grad():
            m = torch.from_numpy(motion).to(dtype)
            pooled = mod.project_text(m.mean(1))
            return mod.seg_decode(m.reshape(b * f, *m.shape[2:]), pooled,
                                  b * f, is_seg=False).double().numpy()

    port32 = port_head(tdec, torch.float32)
    tdec64 = tdec.double()  # in place: the f32 result is taken
    tdec64.text_seg_dec.video_decoder.mid_block.st_attn_0.temp_attn \
        .group_norm.register_forward_hook(spread_hook)
    port64 = port_head(tdec64, torch.float64)
    jax32 = jax_head(dparams, jnp.float32)
    with jax.enable_x64(True):
        jax64 = jax_head(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), dparams), jnp.float64)

    gap = rel_err(port32, jax32)
    pairs = {"jax32-jax64": (jax32, jax64), "port32-port64": (port32, port64),
             "jax32-port64": (jax32, port64), "port64-jax64": (port64, jax64)}
    errs = {name: rel_err(*pair) for name, pair in pairs.items()}
    print(f"seed 31 blurry head: max|x|/std {spread[0]:.4g}, port32-jax32 "
          f"{gap:.3e}, " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    assert gap > TOL
    assert spread[0] > 1e3
    for name in ("jax32-jax64", "port32-port64", "jax32-port64"):
        assert 0.5 * gap < errs[name] < 2 * gap, name
    assert errs["port64-jax64"] < 0.5 * gap
