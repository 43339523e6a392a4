"""The sgm engine surface of the port against the JAX package on the CPU:
the sampler set (with and without `prepare`), the EDM ladder and
`build_sigmas`, the scalings and `ContinuousDenoiser`, the guiders,
`GeneralConditioner`, `DiffusionEngine` (sample, the first stage,
`from_checkpoint`), `do_sample` and `do_img2img` under every `Sampler`,
and the watermark; with the repairs this slice made (3-D kernels in
`load_jax_params`, `unclip_vector_suffix` in the conditioner, the UNet's
label embedding only with an adm vector).

JAX's draws are rebuilt from its key splits (`fold_in(key, i)` for a
sampler's step i) and passed in. Modules and samplers at 1e-4 * max, the
engine's sampling paths at 1e-3 * max, f32."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.diffusion import denoiser as jden
from neurons_tpu.diffusion import samplers as jsam
from neurons_tpu.diffusion import schedule as jsch
from neurons_tpu.models import conditioner as jcond
from neurons_tpu.models import unet2d as junet
from neurons_tpu.models.engine import DiffusionEngine as JEngine
from neurons_tpu.pipelines import api as japi
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.diffusion import denoiser as tden
from neurons_tpu_torch.diffusion import samplers as tsam
from neurons_tpu_torch.diffusion import schedule as tsch
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import conditioner as tcond
from neurons_tpu_torch.models import unet2d as tunet
from neurons_tpu_torch.models.engine import DiffusionEngine as TEngine
from neurons_tpu_torch.pipelines import api as tapi
from neurons_tpu_torch.pipelines import keyframe as tkey
from torch_port_utils import randomize, rel_err, t

TOL = 1e-4
SLICE_TOL = 1e-3

TINY_U = jcfg.UNet2DConfig(model_channels=8, channel_mult=(1, 2),
                           num_res_blocks=1, attention_resolutions=(2,),
                           transformer_depth=(1, 1), num_head_channels=4,
                           context_dim=12, adm_in_channels=16)
TINY_V = jcfg.VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                        norm_num_groups=4)


def port(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


def step_noise(key, n, shape):
    """A JAX sampler's per-step draws: normal(fold_in(key, i), shape)."""
    return [t(jax.random.normal(jax.random.fold_in(key, i), shape))
            for i in range(n)]


# ------------------------------------------------------------ samplers ----

W = np.random.default_rng(0).standard_normal((1, 3, 1, 1)).astype(np.float32)


def j_denoise(x, sigma):
    s = sigma.reshape(-1, 1, 1, 1)
    return jnp.tanh(x * W) * 0.7 + x / (1.0 + s ** 2)


def t_denoise(x, sigma):
    s = sigma.reshape(-1, 1, 1, 1)
    return torch.tanh(x * t(W)) * 0.7 + x / (1.0 + s ** 2)


SAMPLERS = ["euler", "euler_churn", "heun", "euler_ancestral",
            "dpmpp2s_ancestral", "dpmpp2m", "lms"]


@pytest.mark.parametrize("prepare", [True, False], ids=["prepare", "raw"])
@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler(name, prepare):
    x = np.random.default_rng(1).standard_normal((2, 3, 4, 4)).astype(
        np.float32)
    sig = np.asarray(jsch.sd_sigmas(6))
    key = jax.random.PRNGKey(5)
    n = len(sig) - 1
    noise = step_noise(key, n, x.shape)
    jx, js = jnp.asarray(x), jnp.asarray(sig)
    tx, ts = t(x), t(sig)
    if name == "euler":
        ref = jsam.sample_euler(j_denoise, jx, js, prepare=prepare)
        got = tsam.sample_euler(t_denoise, tx, ts, prepare=prepare)
    elif name == "euler_churn":
        ref = jsam.sample_euler(j_denoise, jx, js, s_churn=0.8, s_noise=0.9,
                                key=key, prepare=prepare)
        got = tsam.sample_euler(t_denoise, tx, ts, prepare=prepare,
                                s_churn=0.8, s_noise=0.9, noise=noise)
    elif name == "heun":
        ref = jsam.sample_heun(j_denoise, jx, js, prepare=prepare)
        got = tsam.sample_heun(t_denoise, tx, ts, prepare=prepare)
    elif name == "euler_ancestral":
        ref = jsam.sample_euler_ancestral(j_denoise, jx, js, key, eta=0.8,
                                          s_noise=0.9, prepare=prepare)
        got = tsam.sample_euler_ancestral(t_denoise, tx, ts, eta=0.8,
                                          s_noise=0.9, prepare=prepare,
                                          noise=noise)
    elif name == "dpmpp2s_ancestral":
        ref = jsam.sample_dpmpp2s_ancestral(j_denoise, jx, js, key, eta=0.8,
                                            s_noise=0.9, prepare=prepare)
        got = tsam.sample_dpmpp2s_ancestral(t_denoise, tx, ts, eta=0.8,
                                            s_noise=0.9, prepare=prepare,
                                            noise=noise)
    elif name == "dpmpp2m":
        ref = jsam.sample_dpmpp2m(j_denoise, jx, js, prepare=prepare)
        got = tsam.sample_dpmpp2m(t_denoise, tx, ts, prepare=prepare)
    else:
        ref = jsam.sample_lms(j_denoise, jx, sig, order=3, prepare=prepare)
        got = tsam.sample_lms(t_denoise, tx, ts, order=3, prepare=prepare)
    assert rel_err(got, ref) <= TOL


def test_lms_coefficients():
    sig = np.asarray(jsch.edm_sigmas(7, 0.1, 20.0, 3.0))
    np.testing.assert_allclose(tsam._lms_coefficients(sig, 4),
                               jsam._lms_coefficients(sig, 4), rtol=1e-12,
                               atol=1e-12)


def test_guiders():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 2, 3, 3)).astype(np.float32)
    sigma = np.full((6,), 1.7, np.float32)
    cond = {"a": rng.standard_normal((6, 4)).astype(np.float32)}
    uc = {"a": rng.standard_normal((6, 4)).astype(np.float32)}

    def net(x, c_noise, a):  # either framework's arrays
        return x * a.sum(-1).reshape(-1, 1, 1, 1) + c_noise.reshape(
            -1, 1, 1, 1)

    jd = jden.ContinuousDenoiser(jden.v_scaling)
    td = tden.ContinuousDenoiser(tden.v_scaling)
    tc = {k: t(v) for k, v in cond.items()}
    tu = {k: t(v) for k, v in uc.items()}
    for jg, tg in (
            (jsam.make_cfg_denoiser(jd, net, cond, uc, 2.5),
             tsam.make_cfg_denoiser(td, net, tc, tu, 2.5)),
            (jsam.make_identity_denoiser(jd, net, cond),
             tsam.make_identity_denoiser(td, net, tc)),
            (jsam.make_linear_prediction_denoiser(jd, net, cond, uc, 3),
             tsam.make_linear_prediction_denoiser(td, net, tc, tu, 3))):
        assert rel_err(tg(t(x), t(sigma)), jg(jnp.asarray(x),
                                              jnp.asarray(sigma))) <= TOL


# --------------------------------------------- ladders and the denoisers ----

@pytest.mark.parametrize("disc", ["LEGACY_DDPM", "EDM"])
@pytest.mark.parametrize("strength", [1.0, 0.4, 0.05])
def test_build_sigmas(disc, strength):
    kw = dict(steps=10, img2img_strength=strength, sigma_min=0.03,
              sigma_max=14.6, rho=3.0)
    ref = japi.build_sigmas(japi.SamplingParams(
        discretization=japi.Discretization[disc], **kw))
    got = tapi.build_sigmas(tapi.SamplingParams(
        discretization=tapi.Discretization[disc], **kw))
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= 1e-6
    if strength == 0.4:  # 4 of the 11 zero-appended entries
        assert got.shape == (4,) and float(got[-1]) == 0.0


def test_edm_sigmas():
    for kw in ({}, dict(sigma_min=0.002, sigma_max=700.0),
               dict(append_zero=False)):
        assert rel_err(tsch.edm_sigmas(25, **kw),
                       jsch.edm_sigmas(25, **kw)) <= 1e-6


@pytest.mark.parametrize("scaling", ["eps_scaling", "v_scaling",
                                     "edm_scaling"])
def test_continuous_denoiser(scaling):
    s = np.array([0.03, 1.0, 14.6], np.float32)
    for a, b in zip(getattr(tden, scaling)(t(s)),
                    getattr(jden, scaling)(jnp.asarray(s))):
        assert rel_err(a, b) <= 1e-6
    x = np.random.default_rng(3).standard_normal((3, 2, 4)).astype(
        np.float32)

    def network(x, c_noise, k):
        return x * k + c_noise.reshape(-1, 1, 1)

    ref = jden.ContinuousDenoiser(getattr(jden, scaling))(
        network, jnp.asarray(x), jnp.asarray(s), k=2.0)
    got = tden.ContinuousDenoiser(getattr(tden, scaling))(
        network, t(x), t(s), k=2.0)
    assert rel_err(got, ref) <= TOL


# ---------------------------------------------------------- conditioner ----

def _registry(mod, ucg=0.0, legacy=None):
    return mod.GeneralConditioner([
        mod.Embedder(lambda x: x * 2.0, ("txt",), ucg_rate=ucg,
                     legacy_ucg_val=legacy),                 # -> crossattn
        mod.Embedder(lambda v: v + 1.0, ("vec_a",)),          # -> vector
        mod.Embedder(lambda v: (v, v[..., :2]), ("vec_b",),
                     ucg_rate=ucg),                           # two outputs
        mod.Embedder(lambda x: x, ("img",)),                  # -> concat
    ])


@pytest.mark.parametrize("legacy", [None, 7.0], ids=["zeroing", "legacy"])
def test_general_conditioner(legacy):
    rng = np.random.default_rng(4)
    b = 16
    batch = {"txt": rng.standard_normal((b, 3, 4)).astype(np.float32),
             "vec_a": rng.standard_normal((b, 3)).astype(np.float32),
             "vec_b": rng.standard_normal((b, 4)).astype(np.float32),
             "img": rng.standard_normal((b, 1, 2, 2)).astype(np.float32)}
    tb = {k: t(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(9)
    jreg, treg = _registry(jcond, 0.5, legacy), _registry(tcond, 0.5, legacy)
    # JAX's masks: embedder i draws from fold_in(key, i); the legacy flavour
    # (embedder 0 here) drops where bernoulli(p), the zeroing one keeps
    # where bernoulli(1 - p)
    drops = {}
    for i in (0, 2):
        k_i = jax.random.fold_in(key, i)
        drops[i] = t(np.asarray(
            jax.random.bernoulli(k_i, 0.5, (b,))
            if legacy is not None and i == 0
            else ~jax.random.bernoulli(k_i, 0.5, (b,))))
    assert 0 < int(drops[0].sum()) < b  # both kinds of rows
    ref = jreg(batch, key=key)
    got = treg(tb, drops=drops)
    assert set(got) == set(ref) == {"crossattn", "vector", "concat"}
    for k in ref:
        assert rel_err(got[k], ref[k]) <= TOL
    c, uc = treg.get_unconditional_conditioning(
        tb, force_uc_zero_embeddings=["txt"])
    jc, juc = jreg.get_unconditional_conditioning(
        batch, force_uc_zero_embeddings=["txt"])
    for k in jc:
        assert rel_err(c[k], jc[k]) <= TOL
        np.testing.assert_allclose(uc[k].numpy(), np.asarray(juc[k]),
                                   atol=1e-6)
    # a generator draws masks of its own; none means no dropout
    g = torch.Generator().manual_seed(0)
    assert treg(tb, generator=g)["crossattn"].shape == (b, 3, 4)
    assert torch.equal(treg(tb)["crossattn"], tb["txt"] * 2.0)


def test_unclip_conditioner_and_suffix():
    tc = tcond.unclip_conditioner(lambda img: torch.ones(
        (img.shape[0], 6, 8)))
    batch = {"jpg": torch.zeros((2, 3, 8, 8)),
             "original_size_as_tuple": torch.full((2, 2), 768.0),
             "crop_coords_top_left": torch.zeros((2, 2))}
    out = tc(batch)
    assert out["crossattn"].shape == (2, 6, 8)
    want = np.asarray(jcond.unclip_vector_suffix(2, (768, 640), (3, 0)))
    assert rel_err(tcond.unclip_vector_suffix(2, (768, 640), (3, 0)),
                   want) <= TOL
    assert rel_err(out["vector"], np.asarray(
        jcond.unclip_vector_suffix(2))) <= TOL
    # moved from pipelines/keyframe.py, which imports it back
    assert tkey.unclip_vector_suffix is tcond.unclip_vector_suffix
    assert rel_err(tcond.concat_timestep_embedder(t(np.array(
        [[6.0, 127.0, 0.02]], np.float32)), 256),
        jcond.concat_timestep_embedder(jnp.array([[6.0, 127.0, 0.02]]),
                                       256)) <= TOL


# -------------------------------------------------------------- repairs ----

def test_conv3d_kernel_loads():
    """`load_jax_params` maps a flax 3-D conv kernel (DHWIO) onto
    nn.Conv3d (OIDHW); `jax_tree` maps it back."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)  # NDHWC
    jmod = fnn.Conv(4, (3, 1, 3), padding=[(1, 1), (0, 0), (1, 1)])
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                                      x)["params"], seed=6)
    ref = np.asarray(jmod.apply({"params": params}, x))

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv3d(6, 4, (3, 1, 3), padding=(1, 0, 1))

    mod = Holder()
    load_jax_params(mod, {"conv": params})
    with torch.no_grad():
        got = mod.conv(t(x.transpose(0, 4, 1, 2, 3)))
    assert rel_err(got, ref.transpose(0, 4, 1, 2, 3)) <= TOL
    back = tex.jax_tree(mod)["conv"]
    np.testing.assert_array_equal(back["kernel"], params["kernel"])


def test_unet_without_adm_loads_strictly():
    """SD 2.1's UNet has no adm vector (`model_specs[SD_2_1]`,
    adm_in_channels 0): the JAX UNet then has no label embedding, and the
    port's builds none, so the strict carry-over succeeds (it raised while
    the port always built `label_emb_0/2`)."""
    cfg = dataclasses.replace(TINY_U, adm_in_channels=0)
    jmod = junet.UNetModel(cfg)
    x = np.random.default_rng(7).standard_normal((2, 4, 8, 8)).astype(
        np.float32)
    ctx = np.random.default_rng(8).standard_normal((2, 5, 12)).astype(
        np.float32)
    ts = np.array([3.0, 500.0], np.float32)
    params = randomize(jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x,
                                      ts, ctx)["params"], seed=9)
    assert "label_emb_0" not in params
    tmod = tunet.UNetModel(port(tcfg.UNet2DConfig, cfg), device="cpu").eval()
    assert not hasattr(tmod, "label_emb_0")
    load_jax_params(tmod, params)
    ref = jmod.apply({"params": params}, x, ts, ctx)
    with torch.no_grad():
        got = tmod(t(x), t(ts), t(ctx))
    assert rel_err(got, ref) <= TOL
    assert tapi.model_specs[tapi.ModelArchitecture.SD_2_1].config \
        .adm_in_channels == 0


# ---------------------------------------------------------------- engine ----

@pytest.fixture(scope="module")
def engines():
    """A JAX engine with numpy-drawn parameters and the port's engine
    carrying them."""
    je = JEngine(unet_cfg=TINY_U, vae_cfg=TINY_V,
                 sampler_cfg=jcfg.SamplerConfig(unclip_steps=3))
    x = jnp.zeros((1, 4, 8, 8))
    up = randomize(jax.eval_shape(
        lambda k: je.unet.init(k, x, jnp.zeros((1,)), jnp.zeros((1, 5, 12)),
                               jnp.zeros((1, 16))), jax.random.PRNGKey(0))
        ["params"], seed=10)
    vp = randomize(jax.eval_shape(
        lambda k: je.vae.init(k, jnp.zeros((1, 3, 16, 16))),
        jax.random.PRNGKey(0))["params"], seed=11)
    je.unet_params, je.vae_params = {"params": up}, {"params": vp}
    te = TEngine(unet_cfg=port(tcfg.UNet2DConfig, TINY_U),
                 vae_cfg=port(tcfg.VAEConfig, TINY_V),
                 sampler_cfg=tcfg.SamplerConfig(unclip_steps=3),
                 device="cpu")
    load_jax_params(te.unet, up)
    load_jax_params(te.vae, vp)
    return je, te, up, vp


def test_engine_sample_and_first_stage(engines):
    je, te, _, _ = engines
    rng = np.random.default_rng(12)
    tokens = rng.standard_normal((2, 5, 12)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = je.sample(key, jnp.asarray(tokens), shape=(2, 4, 8, 8))
    k_noise, k_uc = jax.random.split(key)
    got = te.sample(t(tokens),
                    uc_crossattn=t(jax.random.normal(k_uc, tokens.shape)),
                    shape=(2, 4, 8, 8),
                    noise=t(jax.random.normal(k_noise, (2, 4, 8, 8))))
    assert rel_err(got, ref) <= SLICE_TOL
    img = je.decode_first_stage(ref)
    assert rel_err(te.decode_first_stage(t(np.asarray(ref))), img) <= TOL
    assert rel_err(te.encode_first_stage(t(np.asarray(img))),
                   je.encode_first_stage(img)) <= TOL
    assert rel_err(te.conditioner(2), je.conditioner(2)) <= TOL


def test_engine_from_checkpoint(tmp_path, engines):
    """The unclip6 Lightning layout (UNet, VAE and EMA shadows of other
    UNet weights) written by the port's exporters: both engines load the
    EMA weights and sample alike."""
    je, _, up, vp = engines
    sd = {f"model.diffusion_model.{k}": v
          for k, v in tex.ldm_unet_state_dict(up, TINY_U).items()}
    ema_up = randomize(up, seed=13)
    sd.update(tex.ema_state_dict(
        {f"model.diffusion_model.{k}": v
         for k, v in tex.ldm_unet_state_dict(ema_up, TINY_U).items()}))
    sd.update({f"first_stage_model.{k}": v
               for k, v in tex.ldm_vae_state_dict(vp, TINY_V).items()})
    path = str(tmp_path / "unclip6.ckpt")
    torch.save({"state_dict": tex.to_torch(sd)}, path)
    scfg = jcfg.SamplerConfig(unclip_steps=3)
    jl = JEngine.from_checkpoint(path, TINY_U, TINY_V, scfg)
    tl = TEngine.from_checkpoint(path, port(tcfg.UNet2DConfig, TINY_U),
                                 port(tcfg.VAEConfig, TINY_V),
                                 tcfg.SamplerConfig(unclip_steps=3),
                                 device="cpu")
    assert tl.import_report["unet_unused"] == []
    assert tl.import_report["ema_swapped"] == jl.import_report["ema_swapped"]
    got_tree = tex.jax_tree(tl.unet)
    assert rel_err(got_tree["conv_in"]["kernel"],
                   ema_up["conv_in"]["kernel"]) == 0.0
    tokens = np.random.default_rng(14).standard_normal((1, 5, 12)).astype(
        np.float32)
    uc = np.zeros_like(tokens)
    ref = jl.sample(jax.random.PRNGKey(0), jnp.asarray(tokens),
                    uc_crossattn=jnp.asarray(uc), shape=(1, 4, 8, 8))
    k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
    got = tl.sample(t(tokens), uc_crossattn=t(uc), shape=(1, 4, 8, 8),
                    noise=t(jax.random.normal(k_noise, (1, 4, 8, 8))))
    assert rel_err(got, ref) <= SLICE_TOL


def _cond(b):
    rng = np.random.default_rng(16)
    c = {"crossattn": rng.standard_normal((b, 5, 12)).astype(np.float32),
         "vector": rng.standard_normal((b, 16)).astype(np.float32)}
    uc = {"crossattn": np.zeros((b, 5, 12), np.float32),
          "vector": c["vector"]}
    return c, uc


@pytest.mark.parametrize("sampler", list(japi.Sampler), ids=lambda s: s.name)
def test_do_sample(engines, sampler):
    je, te, _, _ = engines
    kw = dict(width=16, height=16, steps=3, scale=3.0, eta=0.8, s_churn=0.5,
              order=3)
    jp = japi.SamplingParams(sampler=sampler, **kw)
    tp = tapi.SamplingParams(sampler=tapi.Sampler[sampler.name], **kw)
    c, uc = _cond(2)
    key = jax.random.PRNGKey(20)
    ref, zref = japi.do_sample(je, jp, key, c, uc, num_samples=2,
                               return_latents=True)
    kn, ks = jax.random.split(key)
    got, z = tapi.do_sample(
        te, tp, {k: t(v) for k, v in c.items()},
        {k: t(v) for k, v in uc.items()}, num_samples=2, return_latents=True,
        start_noise=t(jax.random.normal(kn, (2, 4, 8, 8))),
        noise=step_noise(ks, 3, (2, 4, 8, 8)))
    assert got.shape == (2, 3, 16, 16)
    assert rel_err(z, zref) <= SLICE_TOL
    assert rel_err(got, ref) <= SLICE_TOL


@pytest.mark.parametrize("sampler", list(japi.Sampler), ids=lambda s: s.name)
def test_do_img2img(engines, sampler):
    je, te, _, _ = engines
    kw = dict(width=16, height=16, steps=6, scale=2.0, eta=0.8,
              img2img_strength=0.5, order=3)
    jp = japi.SamplingParams(sampler=sampler, **kw)
    tp = tapi.SamplingParams(sampler=tapi.Sampler[sampler.name], **kw)
    c, uc = _cond(1)
    img = np.random.default_rng(21).uniform(-1, 1, (1, 3, 16, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(22)
    ref, zref = japi.do_img2img(jnp.asarray(img), je, jp, key, c, uc,
                                offset_noise_level=0.1, return_latents=True)
    kn, ko, ks = jax.random.split(key, 3)
    shape = (1, 4, 8, 8)
    got, z = tapi.do_img2img(
        t(img), te, tp, {k: t(v) for k, v in c.items()},
        {k: t(v) for k, v in uc.items()}, offset_noise_level=0.1,
        return_latents=True, start_noise=t(jax.random.normal(kn, shape)),
        offset_noise=t(jax.random.normal(ko, (1, 1, 1, 1))),
        noise=step_noise(ks, 3, shape))
    assert rel_err(z, zref) <= SLICE_TOL
    assert rel_err(got, ref) <= SLICE_TOL


# ------------------------------------------------------------- watermark ----

def test_watermark():
    rng = np.random.default_rng(23)
    imgs = rng.uniform(0.1, 0.9, (2, 3, 64, 96)).astype(np.float32)
    got = tapi.embed_watermark(imgs)
    ref = japi.embed_watermark(imgs)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    for im in got:
        assert tapi.decode_watermark(im) == tapi.WATERMARK_BITS
    assert tapi.WATERMARK_BITS == japi.WATERMARK_BITS
    big = rng.uniform(0.1, 0.9, (1, 3, 768, 768)).astype(np.float32)
    marked = tapi.embed_watermark(big)
    assert tapi.decode_watermark(marked[0]) == tapi.WATERMARK_BITS
    assert float(np.abs(marked - big).max()) < 0.05
