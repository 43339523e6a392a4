"""The SVD stack of the port against the JAX package on the CPU: the
VideoUNet's blocks and the whole UNet, the temporal VAE decoder,
`svd_img2vid` end to end with a chunked decode, and the SVD importers and
`load_svd` on synthetic sgm-layout checkpoints.

JAX trees are shaped with `jax.eval_shape(init)` and every leaf drawn from
numpy (`torch_port_utils.randomize`), so no zero-initialised head (the
UNet's out_conv, proj_out, every temporal out_conv) makes a comparison
vacuous; each test also checks that its output is not all zero. JAX's
draws are rebuilt from its key splits. Modules are held at 1e-4 * max,
the slice at 1e-3 * max, f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.interop import load_weights as jlw
from neurons_tpu.interop import torch_import as jti
from neurons_tpu.models import temporal_ae as jtae
from neurons_tpu.models import video_unet as jvu
from neurons_tpu.pipelines import svd as jsvd
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.interop import load_weights as tlw
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop import torch_import as tti
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import temporal_ae as ttae
from neurons_tpu_torch.models import video_unet as tvu
from neurons_tpu_torch.models.vae import Encoder
from neurons_tpu_torch.pipelines import svd as tsvd
from torch_port_utils import randomize, rel_err, t

TOL = 1e-4
SLICE_TOL = 1e-3

# two levels, attention at both (4x4 and 2x2 latents of 8x8 frames)
UNET = jcfg.VideoUNetConfig(
    in_channels=8, out_channels=4, model_channels=8, channel_mult=(1, 2),
    num_res_blocks=1, attention_resolutions=(1, 2), transformer_depth=(1, 1),
    num_head_channels=4, context_dim=12, adm_in_channels=768,
    video_kernel_size=(3, 1, 1))
DEC = jcfg.VideoDecoderConfig(
    vae=jcfg.VAEConfig(block_out_channels=(8, 16), layers_per_block=1,
                       norm_num_groups=4, latent_channels=4),
    video_kernel_size=(3, 3, 3), alpha=0.2)


def port(cls, jax_cfg):
    """The port's config with the JAX config's values (nested VAEConfig
    converted)."""
    vals = {}
    for f in dataclasses.fields(cls):
        v = getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(v):
            v = port(getattr(tcfg, type(v).__name__), v)
        vals[f.name] = v
    return cls(**vals)


def nonzero(x):
    assert float(np.abs(np.asarray(x)).max()) > 1e-3


def jax_pair(jmod, tmod, seed, *init_args, **init_kw):
    """The JAX module's parameter tree (its init's shapes, every leaf drawn
    from numpy), carried into the port module."""
    params = jax.eval_shape(lambda k: jmod.init(k, *init_args, **init_kw),
                            jax.random.PRNGKey(0))["params"]
    params = randomize(params, seed=seed)
    load_jax_params(tmod.eval(), params)
    return params


def video(x):
    """NDHWC [B, T, H, W, C] (JAX) <-> folded NCHW [(B T), C, H, W]."""
    b, f, h, w, c = x.shape
    return np.ascontiguousarray(x.reshape(b * f, h, w, c).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("strategy", ["fixed", "learned",
                                      "learned_with_images"])
@pytest.mark.parametrize("layout", ["video", "seq"])
def test_alpha_blender(strategy, layout):
    rng = np.random.default_rng(0)
    b, f = 2, 3
    shape = (b, f, 4, 4, 5) if layout == "video" else (b * f, 7, 5)
    xs, xt = (rng.standard_normal(shape, dtype=np.float32) for _ in range(2))
    ioi = np.array([[0, 1, 0], [1, 0, 0]], np.float32)  # stills flagged
    jmod = jvu.AlphaBlender(strategy, 0.3, layout=layout)
    params = jmod.init(jax.random.PRNGKey(0), xs, xt, ioi)
    if strategy != "fixed":
        params = {"params": {"mix_factor": np.array([0.7], np.float32)}}
    ref = np.asarray(jmod.apply(params, xs, xt, ioi))
    tmod = tvu.AlphaBlender(strategy, 0.3)
    if strategy != "fixed":
        load_jax_params(tmod, params["params"])
    fold = video if layout == "video" else (lambda a: a)
    got = tmod(t(fold(xs)), t(fold(xt)), t(ioi))
    assert rel_err(got, fold(ref)) <= TOL
    if strategy == "learned_with_images":  # stills keep the spatial branch
        np.testing.assert_array_equal(got.detach().numpy()[1],
                                      fold(xs)[1])


@pytest.mark.parametrize("kernel,cin,cout,emb", [
    ((3, 1, 1), 8, 8, True), ((3, 3, 3), 8, 8, False),
    ((3, 1, 1), 8, 16, True)], ids=["unet", "decoder", "skip"])
def test_temporal_res_block(kernel, cin, cout, emb):
    rng = np.random.default_rng(1)
    b, f = 2, 3
    x = rng.standard_normal((b, f, 4, 5, cin), dtype=np.float32)
    e = rng.standard_normal((b, f, 12), dtype=np.float32) if emb else None
    jmod = jvu.TemporalResBlock(cout, kernel=kernel, groups=4, use_emb=emb)
    tmod = tvu.TemporalResBlock(cin, cout, kernel, 4, 12 if emb else 0)
    params = jax_pair(jmod, tmod, 2, x, e)
    ref = np.asarray(jmod.apply({"params": params}, x, e))
    with torch.no_grad():
        got = tmod(t(x.transpose(0, 4, 1, 2, 3)),
                   None if e is None else t(e))
    assert rel_err(got, ref.transpose(0, 4, 1, 2, 3)) <= TOL
    nonzero(ref - x if cin == cout else ref)


def test_video_res_block():
    rng = np.random.default_rng(3)
    b, f = 2, 3
    x = rng.standard_normal((b * f, 4, 4, 8), dtype=np.float32)
    emb = rng.standard_normal((b * f, 12), dtype=np.float32)
    ioi = np.array([[0, 0, 1], [0, 0, 0]], np.float32)
    jmod = jvu.VideoResBlock(16, kernel=(3, 1, 1), groups=4)
    tmod = tvu.VideoResBlock(8, 16, 12, (3, 1, 1), 4)
    params = jax_pair(jmod, tmod, 4, x, emb, f, ioi)
    ref = np.asarray(jmod.apply({"params": params}, x, emb, f, ioi))
    with torch.no_grad():
        got = tmod(t(x.transpose(0, 3, 1, 2)), t(emb), f, t(ioi))
    assert rel_err(got, ref.transpose(0, 3, 1, 2)) <= TOL
    nonzero(ref)


@pytest.mark.parametrize("spatial_context", [True, False],
                         ids=["spatial_ctx", "time_ctx"])
def test_spatial_video_transformer(spatial_context):
    rng = np.random.default_rng(5)
    b, f, c = 2, 3, 8
    x = rng.standard_normal((b * f, 4, 4, c), dtype=np.float32)
    ctx = rng.standard_normal((b * f, 2, 12), dtype=np.float32)
    tctx = rng.standard_normal((b, 6), dtype=np.float32)
    ioi = np.array([[0, 1, 0], [0, 0, 0]], np.float32)
    kw = dict(time_context_dim=6, use_spatial_context=spatial_context,
              ff_in=True, groups=4)
    jmod = jvu.SpatialVideoTransformer(c, 2, 4, 1, 12, **kw)
    tmod = tvu.SpatialVideoTransformer(c, 2, 4, 1, 12, **kw)
    args = (x, ctx, f, None if spatial_context else tctx, ioi)
    params = jax_pair(jmod, tmod, 6, *args)
    ref = np.asarray(jmod.apply({"params": params}, *args))
    with torch.no_grad():
        got = tmod(t(x.transpose(0, 3, 1, 2)), t(ctx), f,
                   None if spatial_context else t(tctx), t(ioi))
    assert rel_err(got, ref.transpose(0, 3, 1, 2)) <= TOL
    nonzero(ref - x)


@pytest.fixture(scope="module")
def unet_pair():
    b, f = 1, 3
    jmod = jvu.VideoUNet(UNET)
    tmod = tvu.VideoUNet(port(tcfg.VideoUNetConfig, UNET), device="cpu")
    params = jax_pair(jmod, tmod, 7, jnp.zeros((b * f, 8, 8, 8)),
                      jnp.zeros((b * f,)), jnp.zeros((b * f, 1, 12)),
                      jnp.zeros((b * f, 768)), num_frames=f)
    apply = jax.jit(lambda p, x, ts, ctx, y, ioi: jmod.apply(
        {"params": p}, x, ts, ctx, y, num_frames=f,
        image_only_indicator=ioi))
    return params, apply, tmod


def test_video_unet(unet_pair):
    params, apply, tmod = unet_pair
    rng = np.random.default_rng(8)
    f = 3
    x = rng.standard_normal((f, 8, 8, 8), dtype=np.float32)
    ts = np.array([-1.2, 0.3, 1.1], np.float32)
    ctx = rng.standard_normal((f, 1, 12), dtype=np.float32)
    y = rng.standard_normal((f, 768), dtype=np.float32)
    ioi = np.array([[0, 0, 1]], np.float32)
    ref = np.asarray(apply(params, x, ts, ctx, y, ioi))
    with torch.no_grad():
        got = tmod(t(x), t(ts), t(ctx), t(y), num_frames=f,
                   image_only_indicator=t(ioi))
    assert got.shape == (f, 4, 8, 8)
    assert rel_err(got, ref) <= TOL
    nonzero(ref)


@pytest.fixture(scope="module")
def decoder_pair():
    f = 4
    jmod = jtae.VideoDecoder(DEC)
    tmod = ttae.VideoDecoder(port(tcfg.VideoDecoderConfig, DEC),
                             device="cpu")
    params = jax_pair(jmod, tmod, 9, jnp.zeros((f, 4, 4, 4)), num_frames=f)
    return params, jmod, tmod


@pytest.mark.parametrize("mode", ["conv-only", "all", "attn-only"])
def test_video_decoder(decoder_pair, mode):
    f = 4
    z = np.random.default_rng(10).standard_normal((f, 4, 4, 4),
                                                  dtype=np.float32)
    if mode == "conv-only":
        params, jmod, tmod = decoder_pair
    else:
        cfg = dataclasses.replace(DEC, time_mode=mode)
        jmod = jtae.VideoDecoder(cfg)
        tmod = ttae.VideoDecoder(port(tcfg.VideoDecoderConfig, cfg),
                                 device="cpu")
        params = jax_pair(jmod, tmod, 11, jnp.zeros((f, 4, 4, 4)),
                          num_frames=f)
    ref = np.asarray(jmod.apply({"params": params}, z, num_frames=f))
    with torch.no_grad():
        got = tmod(t(z), f)
    assert got.shape == (f, 3, 8, 8)
    assert rel_err(got, ref) <= TOL
    nonzero(ref)


def test_svd_img2vid_chunked(unet_pair, decoder_pair):
    """The slice: 3 frames, 4 EDM steps, the linear CFG ramp, decoded in
    chunks of 2 frames; the JAX draws rebuilt from its key split."""
    uparams, uapply, tunet = unet_pair
    dparams, jdec, tdec = decoder_pair
    f, key = 3, jax.random.PRNGKey(4)
    rng = np.random.default_rng(12)
    cond = rng.standard_normal((1, 4, 8, 8), dtype=np.float32)
    clip = rng.standard_normal((1, 12), dtype=np.float32)

    def unet_apply(p, x, ts, ctx, y, nf):
        return uapply(p, x, ts, ctx, y, jnp.zeros((x.shape[0] // nf, nf)))

    djit = jax.jit(lambda z, nf: jdec.apply({"params": dparams}, z,
                                            num_frames=nf),
                   static_argnums=1)
    kw = dict(num_frames=f, num_steps=4, fps_id=6.0, motion_bucket_id=127.0,
              cond_aug=0.02, decode_chunk=2)
    # the JAX UNet's context_dim is the tiny 12: the CLIP embedding's width
    ref = jsvd.svd_img2vid(unet_apply, uparams, djit, key, jnp.asarray(cond),
                           jnp.asarray(clip), **kw)
    k_aug, k_noise = jax.random.split(key)
    noise = tsvd.SVDNoise(
        aug=t(jax.random.normal(k_aug, cond.shape)),
        start=t(jax.random.normal(k_noise, (f, 4, 8, 8))))
    got = tsvd.svd_img2vid(tunet, tdec, t(cond), t(clip), noise=noise, **kw)
    assert got.video.shape == (1, f, 3, 16, 16)
    assert rel_err(got.latents, ref.latents) <= SLICE_TOL
    assert rel_err(got.video, ref.video) <= SLICE_TOL
    nonzero(ref.video)


def test_svd_conditioning():
    s = np.array([0.5, 2.0, 700.0], np.float32)
    for a, b in zip(tsvd.v_scaling_edm_cnoise(t(s)),
                    jsvd.v_scaling_edm_cnoise(jnp.asarray(s))):
        assert rel_err(a, b) <= TOL
    assert rel_err(tsvd.svd_vector_conditioning(2, 6.0, 127.0, 0.02),
                   jsvd.svd_vector_conditioning(2, 6.0, 127.0, 0.02)) <= TOL


# ------------------------------------------------------------ importers ----

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.fixture(scope="module")
def reference_replicas():
    """The key-exact torch replicas of the reference's sgm SVD modules
    from the JAX package's own importer tests."""
    import test_svd_video as R
    cfg = dataclasses.replace(R.TINY_VDEC, time_mode="conv-only")
    torch.manual_seed(0)
    return R, R.TVideoUNet(R.TINY_SVD).eval(), \
        R.TVideoDecoder(cfg, "conv-only").eval(), cfg


def test_import_svd_unet(reference_replicas):
    """The reference layout's state dict through both importers: the same
    tree; the port's VideoUNet filled from it agrees with the reference
    replica's forward."""
    R, tu, _, _ = reference_replicas
    sd = tu.state_dict()
    jp, junused = jti.import_svd_unet(sd, R.TINY_SVD)
    tp, tunused = tti.import_svd_unet(sd, R.TINY_SVD)
    assert junused == tunused == []
    assert_same_tree(tp, jp)
    mod = tvu.VideoUNet(port(tcfg.VideoUNetConfig, R.TINY_SVD), device="cpu")
    load_jax_params(mod.eval(), tp)
    b, f = 2, 3
    rng = np.random.RandomState(0)
    x = rng.randn(b * f, 4, 8, 8).astype(np.float32)
    ts = np.linspace(3.0, 40.0, b * f).astype(np.float32)
    ctx = rng.randn(b * f, 5, 12).astype(np.float32)
    y = rng.randn(b * f, 6).astype(np.float32)
    ioi = np.array([[0, 0, 1], [0, 0, 0]], np.float32)
    with torch.no_grad():
        want = tu(t(x), t(ts), t(ctx), t(y), f, t(ioi))
        got = mod(t(x), t(ts), t(ctx), t(y), num_frames=f,
                  image_only_indicator=t(ioi))
    assert rel_err(got, want.numpy()) <= TOL


def test_import_video_decoder(reference_replicas):
    R, _, td, cfg = reference_replicas
    sd = td.state_dict()
    jp, junused = jti.import_video_decoder(sd, cfg)
    tp, tunused = tti.import_video_decoder(sd, cfg)
    assert junused == tunused == []
    assert_same_tree(tp, jp)
    mod = ttae.VideoDecoder(port(tcfg.VideoDecoderConfig, cfg), device="cpu")
    load_jax_params(mod.eval(), tp)
    z = np.random.RandomState(3).randn(3, 3, 4, 4).astype(np.float32)
    with torch.no_grad():
        want = td(t(z), 3)
        got = mod(t(z), 3)
    assert rel_err(got, want.numpy()) <= TOL


@pytest.mark.parametrize("ext", ["safetensors", "ckpt"])
def test_load_svd(tmp_path, unet_pair, decoder_pair, ext):
    """A seeded sgm-layout SVD file written by the port's exporter (plus a
    conditioner key) through the JAX `load_svd` and the port's: the same
    trees, equal to the modules the file was written from."""
    _, _, tunet = unet_pair
    _, _, tdec = decoder_pair
    enc = Encoder(port(tcfg.VAEConfig, DEC.vae))
    torch.manual_seed(1)
    for p in enc.parameters():
        p.data.normal_()
    trees = [tex.jax_tree(m) for m in (tunet, tdec, enc)]
    sd = tex.svd_state_dict(trees[0], UNET, trees[1], DEC, trees[2])
    sd["conditioner.embedders.0.open_clip.dummy"] = np.zeros(1, np.float32)
    path = str(tmp_path / f"svd.{ext}")
    if ext == "safetensors":
        tex.write_safetensors(path, tex.to_torch(sd, torch.float32))
    else:
        torch.save({"state_dict": tex.to_torch(sd)}, path)
    jtrees = jlw.load_svd(path, UNET, DEC)
    ttrees = tlw.load_svd(path, port(tcfg.VideoUNetConfig, UNET),
                          port(tcfg.VideoDecoderConfig, DEC))
    for jt, tt, want in zip(jtrees[:3], ttrees[:3], trees):
        assert_same_tree(tt, jt)
        assert_same_tree(tt, want)
    for report in (jtrees[3], ttrees[3]):
        assert report["unet_unused"] == report["decoder_unused"] == []
        assert report["encoder_unused"] == []
        assert report["conditioner_keys_skipped"] == 1
