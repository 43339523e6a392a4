"""Stage 5's fast paths and the rest of its modules, port against the JAX
package, on the tiny configs.

Modules: the attention hooks of Transformer3D, MotionModule and UNet3DModel
(the encoder cache and the cross, spatial and temporal residuals, extras in
the JAX order, for every combination the samplers use), the site lists,
SparseCtrl's RGB condition branch (`use_simplified_condition_embedding=
False`), `ddim_inversion` and `animate`. Slices: `reconstruct_video` with
each fast branch (TGATE, TGATE x PAB, PAB, encoder reuse) for 6 DDIM steps
over 2 clips of 4 frames, with SparseCtrl, and with the RGB condition.
The UNet3D here is the tiny config cut to one level (cross attention and
a motion module in each block, around the mid block's cross attention),
which keeps every kind of site and cuts the JAX package's tracing and
compile time to a quarter.
JAX trees come from `jax.eval_shape(init)` with every leaf refilled from
numpy (the zero-initialised conv_out, motion proj_out and SparseCtrl heads
would make the comparisons vacuous); the JAX package runs under jit, its
init noise handed to the port. The schedules make every branch take both
its capture and its reuse arm: TGATE gates at step 2 (gated steps capture,
reuse, capture, reuse under TGATE x PAB); PAB (2, 4, 8) over (2, 5) runs
full steps 0, 1, 5, the spatial-only recompute at 2, the cross-only reuse
at 4 and reuses all three at 3; encoder reuse 2 recomputes at 0, 2, 4.
Tolerance: 1e-4 * max |JAX| per module, 1e-3 on latents and video; each
fast output differs from the exact one and each degenerate setting
(tgate_step >= n, encoder_reuse = 1, every PAB interval 1) equals it.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from neurons_tpu.diffusion.ddim import ddim_inversion as jddim_inversion
from neurons_tpu.models import unet3d as ju3
from neurons_tpu.models.sparse_controlnet import SparseControlNetModel as JCN
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu.pipelines import video as jvideo
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.diffusion.ddim import DDIMScheduler, ddim_inversion
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import unet3d as tu3
from neurons_tpu_torch.models.clip import CLIPTextConfig, CLIPTextTower
from neurons_tpu_torch.models.sparse_controlnet import SparseControlNetModel
from neurons_tpu_torch.models.vae import AutoencoderKL
from neurons_tpu_torch.pipelines.video import animate, reconstruct_video
from test_torch_port_fastpath_keyframe import one_thread  # noqa: F401
from test_torch_port_keyframe import port_cfg
from torch_port_utils import randomize, rel_err, t

TOL = 1e-4
SLICE_TOL = 1e-3
B, F, HW, STEPS = 2, 4, 8, 6
PX = 2 * HW          # the tiny VAE halves
RGB_PX = 8 * HW      # the RGB condition branch takes three halvings
KEY = jax.random.PRNGKey(5)


def one_level(u3):
    """The tiny UNet3D config cut to its first level."""
    return dataclasses.replace(
        u3, block_out_channels=(8,),
        down_block_types=("CrossAttnDownBlock3D",),
        up_block_types=("CrossAttnUpBlock3D",),
        motion_module_resolutions=(1,))


@pytest.fixture(autouse=True)
def _default_jax_branches(monkeypatch):
    monkeypatch.delenv("NEURONS_TPU_FUSED_GNCONV", raising=False)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


def jit_apply(module, params, *args, **kw):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a, **kw))(
        params, *args)


def jparams(module, seed, *init_args):
    return randomize(jax.eval_shape(module.init, KEY, *init_args)["params"],
                     seed)


def _tree_err(got, ref, nhwc=False):
    """max rel_err over trees of the same structure; `nhwc`: the port's
    leaves are NCHW features of JAX NHWC ones."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        return max(_tree_err(got[k], ref[k], nhwc) for k in ref)
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        return max(_tree_err(g, r, nhwc) for g, r in zip(got, ref))
    return rel_err(got.permute(0, 2, 3, 1) if nhwc else got, ref)


def _nchw_tree(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_nchw_tree(v) for v in x)
    return nchw(x)


def _dict_t(d):
    return {k: t(v) for k, v in d.items()}


# --- modules ---------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    dict(capture=True), dict(capture_sattn=True),
    dict(capture=True, capture_sattn=True)])
def test_transformer3d_hooks(flags):
    x, ctx = rand(90, 2 * F, 4, 4, 16), rand(91, 2, 5, 12)
    jmod = ju3.Transformer3D(16, 4, 12, F, groups=4, depth=2)
    params = jparams(jmod, 92, x, ctx)
    tmod = tu3.Transformer3D(16, 4, 12, F, depth=2, groups=4).eval()
    load_jax_params(tmod, params)
    ref = jit_apply(jmod, params, x, ctx, **flags)
    with torch.no_grad():
        got = tmod(nchw(x), t(ctx), **flags)
    assert rel_err(got[0].permute(0, 2, 3, 1), ref[0]) <= TOL
    assert _tree_err(got[1:], ref[1:]) <= TOL
    # the captures fed back (from another input) replace their branches
    x2 = rand(93, 2 * F, 4, 4, 16)
    cached = {"xattn_cached" if k == "capture" else "sattn_cached": r
              for k, r in zip(flags, ref[1:])}
    ref2 = jit_apply(jmod, params, x2, ctx, **cached)
    with torch.no_grad():
        got2 = tmod(nchw(x2), t(ctx), **{k: t(v) for k, v in cached.items()})
    assert rel_err(got2.permute(0, 2, 3, 1), ref2) <= TOL


def test_motion_module_hooks():
    x = rand(94, 2 * F, 4, 4, 16)
    jmod = ju3.MotionModule(16, F, heads=2, groups=4)
    params = jparams(jmod, 95, x)
    tmod = tu3.MotionModule(16, F, heads=2, groups=4).eval()
    load_jax_params(tmod, params)
    out, tattn = jit_apply(jmod, params, x, capture_tattn=True)
    with torch.no_grad():
        got, got_t = tmod(nchw(x), capture_tattn=True)
    assert got_t.shape == (2, 2 * F, 16, 16)
    assert rel_err(got.permute(0, 2, 3, 1), out) <= TOL
    assert rel_err(got_t, tattn) <= TOL
    x2 = rand(96, 2 * F, 4, 4, 16)
    ref = jit_apply(jmod, params, x2, tattn_cached=tattn, capture_tattn=True)
    with torch.no_grad():
        got = tmod(nchw(x2), tattn_cached=t(tattn), capture_tattn=True)
    assert rel_err(got[0].permute(0, 2, 3, 1), ref[0]) <= TOL
    assert rel_err(got[1], ref[1]) <= TOL


def test_video_site_lists():
    for port, ref in ((tcfg.UNet3DConfig(), jcfg.UNet3DConfig()),
                      (tcfg.tiny_pipeline_config().unet3d,
                       jcfg.tiny_pipeline_config().unet3d)):
        assert tu3.video_cross_attn_sites(port) == \
            ju3.video_cross_attn_sites(ref)
        assert tu3.video_motion_sites(port) == ju3.video_motion_sites(ref)
    tiny = tcfg.tiny_pipeline_config().unet3d
    unet = tu3.UNet3DModel(tiny, n_frames=F, device="cpu")
    assert [n for n, _ in tu3.video_cross_attn_sites(tiny)] == [
        n for n, _ in unet.named_children() if "_attn_" in n
        or n == "mid_attn"]


@pytest.fixture(scope="module")
def nets():
    cfg = jcfg.tiny_pipeline_config()
    u3 = one_level(cfg.unet3d)
    ctx = u3.cross_attention_dim
    x0 = jnp.zeros((1, 4, F, HW, HW))
    t0, c0 = jnp.zeros((1,)), jnp.zeros((1, 5, ctx))
    junet = ju3.UNet3DModel(u3, n_frames=F)
    uparams = jparams(junet, 100, x0, t0, c0)
    jcn = JCN(u3, n_frames=F)
    cparams = jparams(jcn, 101, x0, t0, c0, x0,
                      jnp.zeros((1, 1, F, HW, HW)))
    jrgb = JCN(u3, n_frames=F, conditioning_channels=3,
               use_simplified_condition_embedding=False)
    rparams = jparams(jrgb, 102, x0, t0, c0,
                      jnp.zeros((1, 3, F, RGB_PX, RGB_PX)),
                      jnp.zeros((1, 1, F, RGB_PX, RGB_PX)))
    jvae = JVAE(cfg.vae)
    vparams = jparams(jvae, 103, jnp.zeros((1, 3, PX, PX)))

    pcfg = port_cfg(tcfg.UNet3DConfig, u3)
    tunet = tu3.UNet3DModel(pcfg, n_frames=F, device="cpu").eval()
    load_jax_params(tunet, uparams)
    tcn = SparseControlNetModel(pcfg, n_frames=F, device="cpu").eval()
    load_jax_params(tcn, cparams)
    trgb = SparseControlNetModel(pcfg, n_frames=F, conditioning_channels=3,
                                 use_simplified_condition_embedding=False,
                                 device="cpu").eval()
    load_jax_params(trgb, rparams)
    tvae = AutoencoderKL(port_cfg(tcfg.VAEConfig, cfg.vae),
                         device="cpu").eval()
    load_jax_params(tvae, vparams)
    rng = np.random.default_rng(104)
    # the JAX package's modules behind one jit each, built once: every
    # trace of the same call is reused across the pipelines below
    flags = ("return_cache", "capture_xattn", "capture_sattn",
             "capture_tattn")
    u3_apply = jax.jit(
        lambda p, x, tt, c, down, mid, **kw: junet.apply(
            {"params": p}, x, tt, c, down, mid, **kw),
        static_argnames=flags)
    cn_apply = {rgb: jax.jit(lambda p, *a, m=m: m.apply({"params": p}, *a))
                for rgb, m in ((False, jcn), (True, jrgb))}
    vae_encode = jax.jit(lambda p, x: jvae.apply(
        {"params": p}, x, method=JVAE.encode).mode())
    vae_decode = jax.jit(lambda p, z: jvae.apply({"params": p}, z,
                                                 method=JVAE.decode))
    return SimpleNamespace(
        u3_apply=u3_apply, cn_apply=cn_apply, vae_encode=vae_encode,
        vae_decode=vae_decode, u3=u3, junet=junet, uparams=uparams, jcn=jcn, cparams=cparams,
        jrgb=jrgb, rparams=rparams, jvae=jvae, vparams=vparams, tunet=tunet,
        tcn=tcn, trgb=trgb, tvae=tvae,
        blurry=rng.random((B, 2, 3, PX, PX), dtype=np.float32),
        keyframe=rng.random((B, 3, PX, PX), dtype=np.float32),
        keyframe_rgb=rng.random((B, 3, RGB_PX, RGB_PX), dtype=np.float32),
        text=rng.standard_normal((B, 5, u3.cross_attention_dim),
                                 dtype=np.float32),
        uncond=rng.standard_normal((B, 5, u3.cross_attention_dim),
                                   dtype=np.float32))


def _unet_inputs(seed, ctx):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, F, HW, HW), dtype=np.float32),
            np.array([961.0, 21.0], np.float32),
            rng.standard_normal((2, 5, ctx), dtype=np.float32))


def _residuals(n, x, ts, text, seed):
    """The JAX SparseCtrl's residuals on a random frame-0 condition."""
    cond = np.zeros((2, 4, F, HW, HW), np.float32)
    cond[:, :, 0] = rand(seed, 2, 4, HW, HW)
    mask = np.zeros((2, 1, F, HW, HW), np.float32)
    mask[:, :, 0] = 1.0
    return jit_apply(n.jcn, n.cparams, x, ts, text, cond, mask,
                     jnp.float32(1.0))


@pytest.mark.parametrize("flags", [
    ("return_cache",), ("capture_xattn",),
    ("capture_sattn", "capture_tattn"),
    ("return_cache", "capture_xattn", "capture_sattn", "capture_tattn"),
])
def test_unet3d_extras_in_jax_order(nets, flags):
    args = _unet_inputs(105, nets.u3.cross_attention_dim)
    down, mid = _residuals(nets, *args, 106)
    kw = {f: True for f in flags}
    ref = jit_apply(nets.junet, nets.uparams, *args, down, mid, **kw)
    with torch.no_grad():
        got = nets.tunet(*(t(a) for a in args), [nchw(r) for r in down],
                         nchw(mid), **kw)
    assert len(got) == len(ref) == 1 + len(flags)
    assert rel_err(got[0], ref[0]) <= TOL
    for flag, g, r in zip(flags, got[1:], ref[1:]):
        assert _tree_err(g, r, nhwc=flag == "return_cache") <= TOL, flag


def test_unet3d_cached_forwards(nets):
    ctx = nets.u3.cross_attention_dim
    a, b = _unet_inputs(107, ctx), _unet_inputs(108, ctx)
    down, mid = _residuals(nets, *b, 109)
    _, enc, xattn, sattn, tattn = jit_apply(
        nets.junet, nets.uparams, *a, return_cache=True, capture_xattn=True,
        capture_sattn=True, capture_tattn=True)
    cases = {
        "cached": (dict(cached=enc), dict(cached=_nchw_tree(enc))),
        "x+s+tattn_cached": (
            dict(xattn_cached=xattn, sattn_cached=sattn, tattn_cached=tattn),
            dict(xattn_cached=_dict_t(xattn), sattn_cached=_dict_t(sattn),
                 tattn_cached=_dict_t(tattn))),
        "x+tattn_cached, capture_s": (
            dict(xattn_cached=xattn, tattn_cached=tattn,
                 capture_sattn=True),
            dict(xattn_cached=_dict_t(xattn), tattn_cached=_dict_t(tattn),
                 capture_sattn=True)),
    }
    for name, (jkw, tkw) in cases.items():
        ref = jit_apply(nets.junet, nets.uparams, *b, down, mid, **jkw)
        with torch.no_grad():
            got = nets.tunet(*(t(x) for x in b), [nchw(r) for r in down],
                             nchw(mid), **tkw)
        assert _tree_err(got, ref) <= TOL, name


def test_sparse_controlnet_rgb_condition(nets):
    ctx = nets.u3.cross_attention_dim
    x, ts, text = _unet_inputs(110, ctx)
    cond = np.zeros((2, 3, F, RGB_PX, RGB_PX), np.float32)
    cond[:, :, 0] = np.random.default_rng(111).random(
        (2, 3, RGB_PX, RGB_PX), dtype=np.float32)
    mask = np.zeros((2, 1, F, RGB_PX, RGB_PX), np.float32)
    mask[:, :, 0] = 1.0
    ref_down, ref_mid = jit_apply(nets.jrgb, nets.rparams, x, ts, text, cond,
                                  mask, jnp.float32(0.8))
    with torch.no_grad():
        down, mid = nets.trgb(t(x), t(ts), t(text), t(cond), t(mask), 0.8)
    assert len(down) == len(ref_down)
    for got, ref in zip(down, ref_down):
        assert rel_err(got.permute(0, 2, 3, 1), ref) <= TOL
    assert rel_err(mid.permute(0, 2, 3, 1), ref_mid) <= TOL
    # the branch's own parameters, with the JAX names
    names = {n.split(".")[0] for n, _ in nets.trgb.named_parameters()}
    assert {"cond_in", "cond_b0a", "cond_b2b", "cond_out"} <= names
    assert "cond_embedding" not in names


def test_ddim_inversion(nets):
    x = rand(112, 2, 4, F, HW, HW)
    text = rand(113, 2, 5, nets.u3.cross_attention_dim)

    def jeps(xx, tt):
        return nets.junet.apply({"params": nets.uparams}, xx,
                                tt.astype(jnp.float32), jnp.asarray(text))

    ref = jax.jit(lambda xx: jddim_inversion(JDDIM.create(10), jeps, xx, 4))(
        jnp.asarray(x))

    def teps(xx, tt):
        return nets.tunet(xx, tt.float(), t(text))

    with torch.no_grad():
        got = ddim_inversion(DDIMScheduler.create(10), teps, t(x), 4)
    assert rel_err(got, ref) <= SLICE_TOL
    assert rel_err(got, x) > 1e-2   # it moved


def test_animate(nets):
    key = jax.random.PRNGKey(114)

    @jax.jit
    def run(uparams, text, uncond):
        return jvideo.animate(
            unet3d_apply=nets.u3_apply, unet3d_params=uparams,
            vae_decode=lambda z: nets.vae_decode(nets.vparams, z), key=key,
            text_embeddings=text, uncond_embeddings=uncond, n_frames=F,
            latent_hw=HW, num_steps=3)

    ref = run(nets.uparams, nets.text, nets.uncond)
    noise = t(jax.random.normal(key, (B, 4, F, HW, HW)))
    got = animate(nets.tunet, nets.tvae, t(nets.text), t(nets.uncond),
                  n_frames=F, latent_hw=HW, num_steps=3, noise=noise,
                  device="cpu")
    assert got.video.shape == (B, F, 3, PX, PX)
    assert rel_err(got.latents, ref.latents) <= SLICE_TOL
    assert rel_err(got.video, ref.video) <= SLICE_TOL


# --- reconstruct_video -------------------------------------------------------

def jax_video(n, rgb=False, **opts):
    @jax.jit
    def run(uparams, cparams, vparams, blurry, keyframe, text, uncond):
        return jvideo.reconstruct_video(
            unet3d_apply=n.u3_apply, unet3d_params=uparams,
            controlnet_apply=n.cn_apply[rgb], controlnet_params=cparams,
            vae_encode_mode=lambda x: n.vae_encode(vparams, x),
            vae_decode=lambda z: n.vae_decode(vparams, z),
            key=KEY, blurry_video=blurry, keyframe=keyframe,
            text_embeddings=text, uncond_embeddings=uncond,
            num_steps=STEPS, n_frames=F, use_simplified_cond=not rgb,
            **opts)

    return run(n.uparams, n.rparams if rgb else n.cparams, n.vparams,
               n.blurry, n.keyframe_rgb if rgb else n.keyframe, n.text,
               n.uncond)


def port_video(n, rgb=False, **opts):
    noise = t(jax.random.normal(KEY, (B, 4, F, HW, HW)))
    return reconstruct_video(
        n.tunet, n.trgb if rgb else n.tcn, n.tvae, t(n.blurry),
        t(n.keyframe_rgb if rgb else n.keyframe), t(n.text), t(n.uncond),
        num_steps=STEPS, n_frames=F, use_simplified_cond=not rgb,
        noise=noise, device="cpu", **opts)


@pytest.fixture(scope="module")
def exact(nets):
    return port_video(nets)


FAST_BRANCHES = {
    "tgate": dict(tgate_step=2),
    "tgate_pab": dict(tgate_step=2, tgate_pab=2),
    "pab": dict(pab=(2, 4, 8), pab_range=(2, 5)),
    "encoder_reuse": dict(encoder_reuse=2),
}


def _compare(got, ref):
    assert got.video.shape == (B, F, 3, PX, PX)
    assert rel_err(got.latents, ref.latents) <= SLICE_TOL
    assert rel_err(got.video, ref.video) <= SLICE_TOL
    assert got.video.min() >= 0 and got.video.max() <= 1


@pytest.mark.parametrize("branch", list(FAST_BRANCHES))
def test_reconstruct_video_fast_branch(nets, exact, branch):
    opts = FAST_BRANCHES[branch]
    got = port_video(nets, **opts)
    _compare(got, jax_video(nets, **opts))
    assert rel_err(got.latents, exact.latents) > 1e-3, branch


def test_reconstruct_video_rgb_condition(nets, exact):
    got = port_video(nets, rgb=True)
    _compare(got, jax_video(nets, rgb=True))
    assert rel_err(got.latents, exact.latents) > 1e-3


@pytest.mark.parametrize("opts", [dict(tgate_step=STEPS),
                                  dict(tgate_step=STEPS + 3, tgate_pab=2),
                                  dict(encoder_reuse=1),
                                  dict(pab=(1, 1, 1))])
def test_reconstruct_video_degenerate_equals_exact(nets, exact, opts):
    got = port_video(nets, **opts)
    assert rel_err(got.latents, exact.latents) <= 1e-6
    assert rel_err(got.video, exact.video) <= 1e-6


@pytest.mark.parametrize("opts,match", [
    (dict(tgate_step=2, encoder_reuse=2), "exclusive"),
    (dict(pab=(1, 2, 4), tgate_step=2), "exclusive"),
    (dict(pab=(1, 2, 4), encoder_reuse=2), "exclusive"),
    (dict(tgate_pab=2), "requires"),
    (dict(pab=(2, 3, 6)), "nest"),
    (dict(pab=(2, 4, 6)), "nest"),
])
def test_reconstruct_video_errors(nets, opts, match):
    with pytest.raises(ValueError, match=match):
        port_video(nets, **opts)


def test_stage5_entry_passes_video_opts(monkeypatch):
    from neurons_tpu_torch.pipelines import e2e
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(e2e, "reconstruct_video", spy)
    tower = CLIPTextTower(CLIPTextConfig.tiny(), device="cpu").eval()
    art = e2e.Stage3Artifacts(
        SimpleNamespace(captions=torch.zeros((1, 4), dtype=torch.long)),
        torch.zeros((1, 3, PX, PX)), torch.zeros((1, 2, 3, PX, PX)))
    with pytest.raises(RuntimeError, match="stop"):
        e2e.run_stage5(tower, None, None, None, art, device="cpu",
                       tgate_step=10, tgate_pab=2)
    assert seen["tgate_step"] == 10 and seen["tgate_pab"] == 2
