"""Stage 5 of the port against the JAX package, on the tiny configs.

Modules: the CLIP text tower, MotionModule, Transformer3D, ResnetBlock3D,
UNet3DModel (with and without SparseCtrl residuals), SparseControlNetModel
and the DDIM scheduler. JAX trees come from `jax.eval_shape(init)`, every
leaf is refilled from numpy (`randomize`: the zero-initialised conv_out,
motion proj_out and SparseCtrl heads would otherwise make the comparisons
vacuous) and carried over with `load_jax_params`. The JAX modules keep
NHWC activations, the port NCHW: inputs, outputs and SparseCtrl residuals
are transposed between the two. Both sides run f32 on the CPU, with the
fused GroupNorm+SiLU+conv branch of the JAX res block left off (its
default). Tolerance: max |port - JAX| <= 1e-4 * max |JAX| per module,
1e-6 for the scheduler's tables and steps.

Slices: `reconstruct_video` with 3 DDIM steps, and the chained stage 3 -> 5
clip (`reconstruct_clip`) against the JAX package composed as bench.py
composes it at its tiny shapes, with the JAX init noise passed as `noise=`.
Tolerance 1e-3 * max |JAX| on latents and video (three CFG-8.5 steps
through two random-weight networks compound the per-module rounding),
captions equal. The 256-px artifact resize is held against
`jax.image.resize(..., "linear")` to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from neurons_tpu.models import unet3d as ju3
from neurons_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from neurons_tpu.models.clip import CLIPTextTower as JCLIP
from neurons_tpu.models.sparse_controlnet import SparseControlNetModel as JCN
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu.pipelines import video as jvideo
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.diffusion.ddim import DDIMScheduler
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import unet3d as tu3
from neurons_tpu_torch.models.clip import CLIPTextConfig, CLIPTextTower
from neurons_tpu_torch.models.sparse_controlnet import SparseControlNetModel
from neurons_tpu_torch.models.vae import AutoencoderKL
from neurons_tpu_torch.pipelines import e2e
from neurons_tpu_torch.pipelines.video import (cccat_interpolate,
                                               reconstruct_video)
from test_torch_port_keyframe import (B, CAP, LAT, jax_draws, jax_stage3,
                                      port_cfg, slice_parts)
from torch_port_utils import randomize, rel_err, t

TOL = 1e-4
SLICE_TOL = 1e-3
F = 4            # frames (the tiny sampler's n_video_frames)
HW = 16          # latent side of the module and reconstruct_video tests
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _default_jax_branches(monkeypatch):
    monkeypatch.delenv("NEURONS_TPU_FUSED_GNCONV", raising=False)


def nchw(x):
    """JAX NHWC activations -> the port's NCHW tensor."""
    return t(x).permute(0, 3, 1, 2)


def jax_params(module, seed, *init_args):
    return randomize(jax.eval_shape(module.init, KEY, *init_args)["params"],
                     seed)


def japply(module, params, *args):
    """module.apply under jit (far quicker on the CPU than op by op)."""
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params,
                                                                  *args)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


# --- modules --------------------------------------------------------------

def test_clip_text_tower():
    jcfg_t = JCLIPConfig.tiny()
    jmod = JCLIP(jcfg_t)
    params = jax_params(jmod, 50, jnp.zeros((1, jcfg_t.context_length),
                                            jnp.int32))
    tmod = CLIPTextTower(CLIPTextConfig(*jcfg_t), device="cpu").eval()
    load_jax_params(tmod, params)
    toks = np.random.default_rng(51).integers(
        0, jcfg_t.vocab_size, (2, jcfg_t.context_length), dtype=np.int32)
    ref_x, ref_pooled = japply(jmod, params, toks)
    with torch.no_grad():
        x, pooled = tmod(torch.from_numpy(toks).long())
    assert rel_err(x, ref_x) <= TOL
    assert rel_err(pooled, ref_pooled) <= TOL


def test_clip_sd15_config_is_quick_gelu():
    assert CLIPTextConfig.sd15() == CLIPTextConfig(*JCLIPConfig.sd15())
    assert CLIPTextConfig.sd15().quick_gelu


def test_temporal_pos_encoding():
    ref = ju3.temporal_pos_encoding(32, 40)
    assert rel_err(tu3.temporal_pos_encoding(32, 40), ref) <= 1e-6


def test_motion_module():
    x = rand(52, 2 * F, 6, 6, 16)
    jmod = ju3.MotionModule(16, F, heads=2, groups=4)
    params = jax_params(jmod, 53, x)
    tmod = tu3.MotionModule(16, F, heads=2, groups=4).eval()
    load_jax_params(tmod, params)
    ref = japply(jmod, params, x)
    with torch.no_grad():
        got = tmod(nchw(x))
    assert rel_err(got.permute(0, 2, 3, 1), ref) <= TOL


def test_transformer3d():
    x, ctx = rand(54, 2 * F, 6, 6, 16), rand(55, 2, 5, 12)
    jmod = ju3.Transformer3D(16, 4, 12, F, groups=4)
    params = jax_params(jmod, 56, x, ctx)
    tmod = tu3.Transformer3D(16, 4, 12, F, groups=4).eval()
    load_jax_params(tmod, params)
    ref = japply(jmod, params, x, ctx)
    with torch.no_grad():
        got = tmod(nchw(x), t(ctx))
    assert rel_err(got.permute(0, 2, 3, 1), ref) <= TOL


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16)])
def test_resnet_block3d(cin, cout):
    x, emb = rand(57, 2 * F, 6, 6, cin), rand(58, 2 * F, 32)
    jmod = ju3.ResnetBlock3D(cout, groups=4)
    params = jax_params(jmod, 59, x, emb)
    tmod = tu3.ResnetBlock3D(cin, cout, 32, groups=4).eval()
    load_jax_params(tmod, params)
    ref = japply(jmod, params, x, emb)
    with torch.no_grad():
        got = tmod(nchw(x), t(emb))
    assert rel_err(got.permute(0, 2, 3, 1), ref) <= TOL


@pytest.fixture(scope="module")
def video_nets():
    """Tiny UNet3D + SparseCtrl of both packages with the same weights."""
    u3 = jcfg.tiny_pipeline_config().unet3d
    ctx = u3.cross_attention_dim
    x0 = jnp.zeros((1, 4, F, HW, HW))
    c0 = jnp.zeros((1, 5, ctx))
    junet = ju3.UNet3DModel(u3, n_frames=F)
    uparams = jax_params(junet, 60, x0, jnp.zeros((1,)), c0)
    jcn = JCN(u3, n_frames=F)
    cparams = jax_params(jcn, 61, x0, jnp.zeros((1,)), c0, x0,
                         jnp.zeros((1, 1, F, HW, HW)))
    pcfg = port_cfg(tcfg.UNet3DConfig, u3)
    tunet = tu3.UNet3DModel(pcfg, n_frames=F, device="cpu").eval()
    load_jax_params(tunet, uparams)
    tcn = SparseControlNetModel(pcfg, n_frames=F, device="cpu").eval()
    load_jax_params(tcn, cparams)
    return u3, junet, uparams, jcn, cparams, tunet, tcn


def _video_inputs(seed, ctx):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 4, F, HW, HW), dtype=np.float32)
    ts = np.array([961.0, 21.0], np.float32)
    text = rng.standard_normal((2, 5, ctx), dtype=np.float32)
    cond = np.zeros((2, 4, F, HW, HW), np.float32)
    cond[:, :, 0] = rng.standard_normal((2, 4, HW, HW), dtype=np.float32)
    mask = np.zeros((2, 1, F, HW, HW), np.float32)
    mask[:, :, 0] = 1.0
    return x, ts, text, cond, mask


def test_sparse_controlnet(video_nets):
    u3, _, _, jcn, cparams, _, tcn = video_nets
    x, ts, text, cond, mask = _video_inputs(62, u3.cross_attention_dim)
    ref_down, ref_mid = japply(jcn, cparams, x, ts, text, cond, mask,
                               jnp.float32(0.7))
    with torch.no_grad():
        down, mid = tcn(t(x), t(ts), t(text), t(cond), t(mask), 0.7)
    assert len(down) == len(ref_down)
    for got, ref in zip(down, ref_down):
        # the JAX residuals are NHWC, the port's NCHW
        assert rel_err(got.permute(0, 2, 3, 1), ref) <= TOL
    assert rel_err(mid.permute(0, 2, 3, 1), ref_mid) <= TOL


@pytest.mark.parametrize("residuals", [False, True])
def test_unet3d(video_nets, residuals):
    u3, junet, uparams, jcn, cparams, tunet, _ = video_nets
    x, ts, text, cond, mask = _video_inputs(63, u3.cross_attention_dim)
    down = mid = tdown = tmid = None
    if residuals:
        down, mid = japply(jcn, cparams, x, ts, text, cond, mask,
                           jnp.float32(1.0))
        tdown = [nchw(r) for r in down]
        tmid = nchw(mid)
    ref = japply(junet, uparams, x, ts, text, down, mid)
    with torch.no_grad():
        got = tunet(t(x), t(ts), t(text), tdown, tmid)
    assert got.shape == (2, 4, F, HW, HW)
    assert rel_err(got, ref) <= TOL


def test_unet3d_heads_rule_and_motion_sites():
    # full width: 8 heads at every level (hd 40, 80, 160); a motion module
    # at every level of the UNet3D (two temporal attentions each) and of
    # SparseCtrl (one each), and none in the mid block
    cfg = tcfg.UNet3DConfig()
    assert [tu3.spatial_heads(cfg, ch) for ch in cfg.block_out_channels] \
        == [8, 8, 8, 8]
    tiny = tcfg.tiny_pipeline_config().unet3d
    assert tu3.spatial_heads(tiny, 16) == 4
    unet = tu3.UNet3DModel(tiny, n_frames=F, device="cpu")
    cn = SparseControlNetModel(tiny, n_frames=F, device="cpu")
    sites = [n for n, _ in unet.named_children() if "_motion_" in n]
    assert sites == ju3.video_motion_sites(jcfg.tiny_pipeline_config().unet3d)
    assert all(getattr(unet, s).n_attn == 2 for s in sites)
    assert len(ju3.video_motion_sites(jcfg.UNet3DConfig())) == 20
    cn_sites = [n for n, _ in cn.named_children() if "_motion_" in n]
    assert len(cn_sites) == 4 and all(getattr(cn, s).n_attn == 1
                                      for s in cn_sites)


def test_unet3d_config_matches_jax():
    for port, ref in ((tcfg.UNet3DConfig(), jcfg.UNet3DConfig()),
                      (tcfg.tiny_pipeline_config().unet3d,
                       jcfg.tiny_pipeline_config().unet3d)):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_ddim_scheduler():
    jsched, tsched = JDDIM.create(25), DDIMScheduler.create(25)
    np.testing.assert_array_equal(tsched.timesteps.numpy(),
                                  np.asarray(jsched.timesteps))
    assert tsched.timesteps[0] == 961 and tsched.timesteps[-1] == 1
    assert rel_err(tsched.alphas_cumprod, jsched.alphas_cumprod) <= 1e-6
    sample, noise = rand(64, 2, 4, 3, 5, 5), rand(65, 2, 4, 3, 5, 5)
    tt = np.array([961, 1])
    ref = jsched.add_noise(sample, noise, jnp.asarray(tt))
    got = tsched.add_noise(t(sample), t(noise), torch.from_numpy(tt))
    assert rel_err(got, ref) <= 1e-6
    for step in (961, 481, 1):
        ref = jsched.step(noise, jnp.asarray(step), sample)
        assert rel_err(tsched.step(t(noise), step, t(sample)), ref) <= 1e-6


def test_cccat_interpolate():
    x = rand(66, 2, 6, 3, 4, 4)
    ref = jvideo.cccat_interpolate(x, 16)
    assert rel_err(cccat_interpolate(t(x), 16), ref) <= 1e-6
    ref = jvideo.cccat_interpolate(x, 12)
    assert rel_err(cccat_interpolate(t(x), 12), ref) <= 1e-6


# --- slices ---------------------------------------------------------------

def _jax_video(vae, vparams, junet, uparams, jcn, cparams, key, blurry,
               keyframe, text, uncond, n_frames):
    def u3(p, x, tt, c, down, mid):
        return junet.apply({"params": p}, x, tt, c, down, mid)

    def cna(p, x, tt, c, cond, mask, scale):
        return jcn.apply({"params": p}, x, tt, c, cond, mask, scale)

    @jax.jit
    def run(uparams, cparams, vparams, blurry, keyframe, text, uncond):
        return jvideo.reconstruct_video(
            unet3d_apply=u3, unet3d_params=uparams,
            controlnet_apply=cna, controlnet_params=cparams,
            vae_encode_mode=lambda x: vae.apply({"params": vparams}, x,
                                                method=JVAE.encode).mode(),
            vae_decode=lambda z: vae.apply({"params": vparams}, z,
                                           method=JVAE.decode),
            key=key, blurry_video=blurry, keyframe=keyframe,
            text_embeddings=text, uncond_embeddings=uncond, num_steps=3,
            n_frames=n_frames)

    return run(uparams, cparams, vparams, blurry, keyframe, text, uncond)


def test_reconstruct_video(video_nets):
    u3, junet, uparams, jcn, cparams, tunet, tcn = video_nets
    cfg = jcfg.tiny_pipeline_config()
    jvae = JVAE(cfg.vae)
    vparams = jax_params(jvae, 67, jnp.zeros((1, 3, 16, 16)))
    tvae = AutoencoderKL(port_cfg(tcfg.VAEConfig, cfg.vae),
                         device="cpu").eval()
    load_jax_params(tvae, vparams)
    rng = np.random.default_rng(68)
    px = 2 * HW  # the tiny VAE halves: 32 px -> 16x16 latents
    blurry = rng.random((2, 2, 3, px, px), dtype=np.float32)
    keyframe = rng.random((2, 3, px, px), dtype=np.float32)
    text = rng.standard_normal((2, 5, u3.cross_attention_dim),
                               dtype=np.float32)
    uncond = rng.standard_normal(text.shape, dtype=np.float32)
    key = jax.random.PRNGKey(69)
    ref = _jax_video(jvae, vparams, junet, uparams, jcn, cparams, key,
                     blurry, keyframe, text, uncond, F)
    noise = t(jax.random.normal(key, ref.latents.shape))
    got = reconstruct_video(tunet, tcn, tvae, t(blurry), t(keyframe),
                            t(text), t(uncond), num_steps=3, n_frames=F,
                            noise=noise, device="cpu")
    assert got.video.shape == (2, F, 3, px, px)
    assert rel_err(got.latents, ref.latents) <= SLICE_TOL
    assert rel_err(got.video, ref.video) <= SLICE_TOL
    assert got.video.min() >= 0 and got.video.max() <= 1


def test_reconstruct_clip_chained():
    """Stage 3 -> 5 at the bench's tiny shapes (keyframe latents 8, 16-px
    artifacts, 8x8 video latents, 8-token captions, 4 frames): the port's
    `reconstruct_clip` against the JAX package's `reconstruct_keyframes`,
    blurry decode, `jax.image.resize "linear"`, `CLIPTextTower` and
    `reconstruct_video`, composed as bench.py:252-331 composes them."""
    p = slice_parts(38)  # the well-conditioned stage-3 instance
    cfg = p.cfg
    art, lat_vid, n_frames = 16, 8, cfg.sampler.n_video_frames
    tc = JCLIPConfig.tiny()
    u3 = jcfg.replace(cfg.unet3d, cross_attention_dim=tc.width,
                      motion_max_seq_length=8)
    x0 = jnp.zeros((1, 4, n_frames, lat_vid, lat_vid))
    c0 = jnp.zeros((1, tc.context_length, tc.width))
    jtext = JCLIP(tc)
    tparams = jax_params(jtext, 70, jnp.zeros((1, tc.context_length),
                                              jnp.int32))
    junet = ju3.UNet3DModel(u3, n_frames=n_frames)
    uparams = jax_params(junet, 71, x0, jnp.zeros((1,)), c0)
    jcn = JCN(u3, n_frames=n_frames)
    cparams = jax_params(jcn, 72, x0, jnp.zeros((1,)), c0, x0,
                         jnp.zeros((1, 1, n_frames, lat_vid, lat_vid)))

    # the JAX package, composed as the bench composes its stage3 / stage5
    @jax.jit
    def jax_stage3_artifacts():
        out = jax_stage3(p)
        blurry = jax.lax.map(lambda zi: p.jvae.apply(
            {"params": p.vparams}, zi[None], method=JVAE.decode)[0],
            out.blurry_latents)
        blurry = jnp.clip(blurry / 2 + 0.5, 0.0, 1.0)
        blurry = blurry.reshape(B, cfg.decoupler.n_frames, *blurry.shape[1:])
        keyframe = jax.image.resize(out.keyframes, (B, 3, art, art),
                                    "linear")
        blurry = jax.image.resize(blurry, blurry.shape[:3] + (art, art),
                                  "linear")
        toks = jnp.zeros((B, tc.context_length), jnp.int32)
        toks = toks.at[:, :CAP].set(out.captions[:, :tc.context_length]
                                    % tc.vocab_size)
        text = jtext.apply({"params": tparams}, toks)[0]
        uncond = jtext.apply({"params": tparams},
                             jnp.zeros((B, tc.context_length), jnp.int32))[0]
        return out.captions, keyframe, blurry, text, uncond

    captions, keyframe, blurry, text, uncond = jax_stage3_artifacts()
    ref = _jax_video(p.jvae, p.vparams, junet, uparams, jcn, cparams, p.key,
                     blurry, keyframe, text, uncond, n_frames)

    # the port
    ttext = CLIPTextTower(CLIPTextConfig(*tc), device="cpu").eval()
    load_jax_params(ttext, tparams)
    pu3 = port_cfg(tcfg.UNet3DConfig, u3)
    tunet = tu3.UNet3DModel(pu3, n_frames=n_frames, device="cpu").eval()
    load_jax_params(tunet, uparams)
    tcn = SparseControlNetModel(pu3, n_frames=n_frames, device="cpu").eval()
    load_jax_params(tcn, cparams)
    noise = e2e.ClipNoise(jax_draws(p.key, cfg),
                          t(jax.random.normal(p.key, ref.latents.shape)))
    got = e2e.reconstruct_clip(
        p.tdec, p.tunet, p.tvae, ttext, tunet, tcn, t(p.voxel),
        t(p.class_embeds), port_cfg(tcfg.SamplerConfig, cfg.sampler),
        latent_hw=LAT, artifact_hw=art, caption_len=CAP, noise=noise,
        device="cpu")

    np.testing.assert_array_equal(got.stage3.outputs.captions.numpy(),
                                  np.asarray(captions))
    assert rel_err(got.stage3.keyframe, keyframe) <= SLICE_TOL
    assert rel_err(got.stage3.blurry_video, blurry) <= SLICE_TOL
    assert got.video.shape == (B, n_frames, 3, art, art)
    assert rel_err(got.latents, ref.latents) <= SLICE_TOL
    assert rel_err(got.video, ref.video) <= SLICE_TOL


@pytest.mark.parametrize("src", [768, 512])
def test_artifact_resize_matches_jax_linear(src):
    # the keyframe (768 px) and the blurry frames (512 px) down to 256 px;
    # jax.image.resize "linear" antialiases on downsampling
    x = np.random.default_rng(73).random((1, 2, 3, src, src),
                                         dtype=np.float32)
    ref = jax.image.resize(x, (1, 2, 3, 256, 256), "linear")
    assert rel_err(e2e.resize_linear(t(x), 256), ref) <= 1e-5


def test_caption_tokens_are_the_bench_rows():
    caps = torch.tensor([[50256, 49408, 7, 49407], [1, 2, 3, 4]])
    toks = e2e.caption_tokens(caps, 6, 49408)
    assert toks.tolist() == [[848, 0, 7, 49407, 0, 0], [1, 2, 3, 4, 0, 0]]
    assert e2e.caption_tokens(caps, 3, 49408).shape == (2, 3)


def test_stage5_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.tiny_pipeline_config()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tu3.UNet3DModel(cfg.unet3d, n_frames=F)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CLIPTextTower(CLIPTextConfig.tiny())
    unet = tu3.UNet3DModel(cfg.unet3d, n_frames=F, device="cpu")
    cn = SparseControlNetModel(cfg.unet3d, n_frames=F, device="cpu")
    vae = AutoencoderKL(cfg.vae, device="cpu")
    z = torch.zeros(1, 2, 3, 32, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        reconstruct_video(unet, cn, vae, z, z[:, 0], torch.zeros(1, 5, 16),
                          torch.zeros(1, 5, 16), n_frames=F)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        e2e.reconstruct_clip(unet, unet, vae, unet, unet, cn,
                             torch.zeros(1, 1, 8), torch.zeros(7, 24))
