"""Stage 3's fast paths, port against the JAX package, on the tiny config.

The three sampler variants (`sample_euler_tgate` with and without its PAB
phase, `sample_euler_pab`, `sample_euler_encoder_reuse`) run on the same
closed-form denoisers in both frameworks. The unCLIP UNet's hooks (encoder
cache, DeepCache feature, cross- and self-attention residuals) are held
to the JAX UNet's, extras in the JAX order, for every combination the
samplers use. `unclip_sample` runs each fast branch (TGATE, TGATE x PAB,
PAB, DeepCache, encoder reuse) for 6 steps in both packages on the same
weights (every leaf drawn from numpy: the zero-initialised out_conv and
proj_out would make the comparison vacuous) and the same draws, rebuilt
from the JAX key splits; the schedules are chosen so that every branch
takes both its capture and its reuse arm. Tolerance: 1e-3 * max |JAX|,
the slice tests' f32 tolerance; each fast output differs from the exact
one, and each degenerate setting (tgate_step >= n, encoder_reuse = 1,
every PAB interval 1) equals it. Also: the exclusivity and nesting
errors, and the port's copy of the CLI's fast presets.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.diffusion import samplers as jsamplers
from neurons_tpu.models.unet2d import UNetModel as JUNet
from neurons_tpu.models.unet2d import precompute_context_kv as jkv
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu.pipelines import keyframe as jkf
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.diffusion import samplers as tsamplers
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models.unet2d import UNetModel
from neurons_tpu_torch.models.vae import AutoencoderKL
from neurons_tpu_torch.pipelines import keyframe as tkf
from test_torch_port_keyframe import port_cfg
from torch_port_utils import randomize, rel_err, t

TOL = 1e-3
B, LAT, STEPS = 2, 8, 6
TOKENS, CTX = 16, 32     # the tiny prior's CLIP tokens
KEY = jax.random.PRNGKey(3)


@pytest.fixture(autouse=True)
def _default_jax_branches(monkeypatch):
    monkeypatch.delenv("NEURONS_TPU_FUSED_GNCONV", raising=False)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tiny tensors: the suite's workers
    share the cores, and oversubscribed OpenMP threads stall tiny ops (a
    6-worker run of such a test took minutes at the default count and
    seconds at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the samplers ----------------------------------------------------------

def _ladder():
    return np.array([14.6, 6.0, 2.5, 1.1, 0.45, 0.2, 0.08, 0.0], np.float32)


def _x0():
    return np.random.default_rng(70).standard_normal((2, 3, 4, 4),
                                                     dtype=np.float32)


def _dn(x, sigma, w):
    """A closed-form denoiser: the same arithmetic in either framework."""
    s = sigma.reshape((-1,) + (1,) * (x.ndim - 1))
    return x * w / (1.0 + s * s) + 0.05 * s


def _run_both(fn_jax, fn_port):
    sig = _ladder()
    ref = fn_jax(jnp.asarray(_x0()), jnp.asarray(sig))
    got = fn_port(t(_x0()), t(sig))
    return got, ref


@pytest.mark.parametrize("gate,interval", [(3, 0), (2, 2), (1, 3), (9, 2)])
def test_sample_euler_tgate(gate, interval):
    def make(np_):
        full = functools.partial(_dn, w=0.9)

        def capture(x, s):
            return _dn(x, s, 0.9), 0.3 * x.mean()

        def gated(x, s, cache):
            return _dn(x, s, 0.7) + cache

        def gcap(x, s, cache):
            return _dn(x, s, 0.6) + cache, 0.1 * x

        def greuse(x, s, cache, st):
            return _dn(x, s, 0.5) + cache + st

        return full, capture, gated, gcap, greuse

    def run(mod, x, sig):
        full, cap, gated, gcap, greuse = make(mod)
        return mod.sample_euler_tgate(
            full, cap, gated, x, sig, gate, denoise_gated_capture=gcap,
            denoise_gated_reuse=greuse, gated_interval=interval)

    got, ref = _run_both(functools.partial(run, jsamplers),
                         functools.partial(run, tsamplers))
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("intervals,rng", [((2, 4), None), ((1, 3), (1, 5)),
                                           ((2, 4), (2, 5))])
def test_sample_euler_pab(intervals, rng):
    def denoise_pab(x, s, caches, use_x, use_s):
        cx, cs = (None, None) if caches is None else caches
        nx = cx if use_x else 0.2 * x
        ns = cs if use_s else 0.1 * x / (1.0 + abs(x))
        return _dn(x, s, 0.8) + nx - ns, (nx, ns)

    def run(mod, x, sig):
        return mod.sample_euler_pab(denoise_pab, x, sig, intervals,
                                    pab_range=rng)

    got, ref = _run_both(functools.partial(run, jsamplers),
                         functools.partial(run, tsamplers))
    assert rel_err(got, ref) <= 1e-5


@pytest.mark.parametrize("reuse", [1, 2, 3])
def test_sample_euler_encoder_reuse(reuse):
    def full(x, s):
        return _dn(x, s, 0.9), 0.25 * x

    def cached(x, s, cache):
        return _dn(x, s, 0.6) + cache

    def run(mod, x, sig):
        return mod.sample_euler_encoder_reuse(full, cached, x, sig, reuse)

    got, ref = _run_both(functools.partial(run, jsamplers),
                         functools.partial(run, tsamplers))
    assert rel_err(got, ref) <= 1e-5
    if reuse == 1:
        exact = tsamplers.sample_euler(lambda x, s: full(x, s)[0],
                                       t(_x0()), t(_ladder()))
        assert torch.equal(got, exact)


def test_sampler_nesting_and_clamp():
    with pytest.raises(ValueError, match="nest"):
        tsamplers.sample_euler_pab(None, t(_x0()), t(_ladder()), (3, 4))
    # gate_step >= n and gate_step <= 0 clamp to [1, n]: >= n is exact
    full = functools.partial(_dn, w=0.9)
    exact = tsamplers.sample_euler(full, t(_x0()), t(_ladder()))
    got = tsamplers.sample_euler_tgate(
        full, lambda x, s: (full(x, s), None), None, t(_x0()), t(_ladder()),
        50)
    assert torch.equal(got, exact)


# --- the unCLIP UNet's hooks and unclip_sample ------------------------------

@pytest.fixture(scope="module")
def parts():
    cfg = jcfg.tiny_pipeline_config()
    ucfg = jcfg.replace(cfg.unet2d, adm_in_channels=1024)
    junet = JUNet(ucfg)
    uparams = randomize(jax.eval_shape(
        junet.init, KEY, jnp.zeros((2, 4, LAT, LAT)), jnp.zeros((2,)),
        jnp.zeros((2, TOKENS, CTX)), jnp.zeros((2, 1024)))["params"], 80)
    jvae = JVAE(cfg.vae)
    vparams = randomize(jax.eval_shape(
        jvae.init, KEY, jnp.zeros((1, 3, 16, 16)))["params"], 81)
    tunet = UNetModel(port_cfg(tcfg.UNet2DConfig, ucfg), device="cpu").eval()
    load_jax_params(tunet, uparams)
    tvae = AutoencoderKL(port_cfg(tcfg.VAEConfig, cfg.vae),
                         device="cpu").eval()
    load_jax_params(tvae, vparams)
    tokens = np.random.default_rng(82).standard_normal((B, TOKENS, CTX),
                                                       dtype=np.float32)
    return SimpleNamespace(ucfg=ucfg, junet=junet, uparams=uparams,
                           jvae=jvae, vparams=vparams, tunet=tunet,
                           tvae=tvae, tokens=tokens)


def _unet_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 4, LAT, LAT), dtype=np.float32),
            np.array([900.0, 31.0], np.float32),
            rng.standard_normal((2, TOKENS, CTX), dtype=np.float32),
            rng.standard_normal((2, 1024), dtype=np.float32))


def _japply(p, args, **kw):
    fn = jax.jit(lambda params, *a: p.junet.apply({"params": params}, *a,
                                                   **kw))
    return fn(p.uparams, *args)


def _tree_err(got, ref):
    """max rel_err over two trees of arrays with the same structure."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        return max(_tree_err(got[k], ref[k]) for k in ref)
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        return max(_tree_err(g, r) for g, r in zip(got, ref))
    return rel_err(got, ref)


def _nchw_tree(x):
    """JAX NHWC features (the encoder cache) -> the port's layout."""
    if isinstance(x, (tuple, list)):
        return type(x)(_nchw_tree(v) for v in x)
    return t(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("flags", [
    ("return_cache",), ("return_deep_cache",), ("capture_xattn",),
    ("capture_sattn",), ("capture_xattn", "capture_sattn"),
    ("return_cache", "return_deep_cache", "capture_xattn", "capture_sattn"),
])
def test_unet_extras_in_jax_order(parts, flags):
    args = _unet_inputs(83)
    kw = {f: True for f in flags}
    ref = _japply(parts, args, **kw)
    with torch.no_grad():
        got = parts.tunet(*(t(a) for a in args), **kw)
    assert len(got) == len(ref) == 1 + len(flags)
    assert rel_err(got[0], ref[0]) <= 1e-4
    for flag, g, r in zip(flags, got[1:], ref[1:]):
        if flag == "return_cache":
            g = (g[0].permute(0, 2, 3, 1),
                 tuple(s.permute(0, 2, 3, 1) for s in g[1]))
        elif flag == "return_deep_cache":
            g = g.permute(0, 2, 3, 1)
        assert _tree_err(g, r) <= 1e-4, flag


def test_unet_cached_forwards(parts):
    # every cached path fed with the JAX UNet's own captures from another
    # input, so the cached values differ from what the step would compute
    a, b = _unet_inputs(84), _unet_inputs(85)
    _, enc, deep, xattn, sattn = _japply(
        parts, a, return_cache=True, return_deep_cache=True,
        capture_xattn=True, capture_sattn=True)
    cases = {
        "cached": (dict(cached=enc), dict(cached=_nchw_tree(enc))),
        "deep_cached": (dict(deep_cached=deep),
                        dict(deep_cached=_nchw_tree(deep))),
        "xattn_cached": (dict(xattn_cached=xattn),
                         dict(xattn_cached={k: t(v) for k, v in
                                            xattn.items()})),
        "x+sattn_cached": (
            dict(xattn_cached=xattn, sattn_cached=sattn),
            dict(xattn_cached={k: t(v) for k, v in xattn.items()},
                 sattn_cached={k: t(v) for k, v in sattn.items()})),
        "xattn_cached+capture_sattn": (
            dict(xattn_cached=xattn, capture_sattn=True),
            dict(xattn_cached={k: t(v) for k, v in xattn.items()},
                 capture_sattn=True)),
    }
    for name, (jkw, tkw) in cases.items():
        ref = jax.jit(lambda params, *args, jkw=jkw: parts.junet.apply(
            {"params": params}, *args, **jkw))(parts.uparams, *b)
        with torch.no_grad():
            got = parts.tunet(*(t(x) for x in b), **tkw)
        assert _tree_err(got, ref) <= 1e-4, name


def jax_unclip(p, **opts):
    def unet_apply(params, x, tt, ctx, vec, **kw):
        return p.junet.apply({"params": params}, x, tt, ctx, vec, **kw)

    def vae_decode(z):
        return p.jvae.apply({"params": p.vparams}, z, method=JVAE.decode)

    run = jax.jit(lambda uparams, tokens: jkf.unclip_sample(
        unet_apply, uparams, vae_decode, KEY, tokens, num_steps=STEPS,
        latent_hw=LAT, precompute_kv=lambda pp, c: jkv(pp, c, p.ucfg),
        **opts))
    return run(p.uparams, jnp.asarray(p.tokens))


def unclip_draws():
    """unclip_sample's draws, rebuilt from the JAX key splits."""
    k_z, k_noise, k_offset, k_uc = jax.random.split(KEY, 4)
    lat = (B, 4, LAT, LAT)
    return tkf.UnclipNoise(t(jax.random.normal(k_z, lat)),
                           t(jax.random.normal(k_noise, lat)),
                           t(jax.random.normal(k_offset, (B,))),
                           t(jax.random.normal(k_uc, (B, TOKENS, CTX))))


def port_unclip(p, **opts):
    return tkf.unclip_sample(p.tunet, p.tvae, t(p.tokens), num_steps=STEPS,
                             latent_hw=LAT, noise=unclip_draws(), **opts)


@pytest.fixture(scope="module")
def exact(parts):
    return port_unclip(parts)


# steps 0-1 full, 2 capture, 3-5 gated; gated steps capture, reuse,
# capture, reuse; PAB (2, 4) over (1, 5): full 0, 1, 4, 5, spatial
# recompute 2, both reused 3; DeepCache / encoder reuse: full 0 and 3,
# cached 1, 2, 4, 5
FAST_BRANCHES = {
    "tgate": dict(tgate_step=3),
    "tgate_pab": dict(tgate_step=2, tgate_pab=2),
    "pab": dict(pab=(2, 4), pab_range=(1, 5)),
    "deep_cache": dict(deep_cache=3),
    "encoder_reuse": dict(encoder_reuse=3),
}


@pytest.mark.parametrize("branch", list(FAST_BRANCHES))
def test_unclip_sample_fast_branch(parts, exact, branch):
    opts = FAST_BRANCHES[branch]
    ref = jax_unclip(parts, **opts)
    got = port_unclip(parts, **opts)
    assert got.shape == (B, 3, 2 * LAT, 2 * LAT)
    assert rel_err(got, ref) <= TOL
    # the fast path really left the exact trajectory
    assert rel_err(got, exact) > 1e-3, branch


def test_unclip_sample_exact_matches_jax(parts, exact):
    assert rel_err(exact, jax_unclip(parts)) <= TOL


@pytest.mark.parametrize("opts", [dict(tgate_step=STEPS),
                                  dict(tgate_step=STEPS + 5, tgate_pab=2),
                                  dict(encoder_reuse=1),
                                  dict(pab=(1, 1))])
def test_unclip_sample_degenerate_equals_exact(parts, exact, opts):
    assert rel_err(port_unclip(parts, **opts), exact) <= 1e-6


@pytest.mark.parametrize("opts", [
    dict(tgate_step=2, encoder_reuse=2), dict(pab=(1, 2), tgate_step=2),
    dict(pab=(1, 2), encoder_reuse=2), dict(tgate_pab=2),
    dict(deep_cache=2, tgate_step=2), dict(deep_cache=2, pab=(1, 2)),
    dict(deep_cache=2, encoder_reuse=2)])
def test_unclip_sample_exclusivity(parts, opts):
    for run in (lambda: port_unclip(parts, **opts),
                lambda: tkf.check_fast_options(**opts)):
        with pytest.raises(ValueError):
            run()


def test_reconstruct_keyframes_passes_sampler_opts(monkeypatch):
    seen = {}

    def spy(*args, **kw):
        seen.update(kw)
        raise RuntimeError("stop")

    monkeypatch.setattr(tkf, "unclip_sample", spy)
    cfg = tcfg.tiny_pipeline_config()
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    dec = NeuronsDecoupler(cfg.brain, cfg.prior, cfg.decoupler,
                           tiny_gpt2_config(), device="cpu").eval()
    unet = UNetModel(tcfg.replace(cfg.unet2d, adm_in_channels=1024),
                     device="cpu").eval()
    vae = AutoencoderKL(cfg.vae, device="cpu").eval()
    voxel = torch.randn((1, 1, cfg.brain.voxel_counts[0]))
    with pytest.raises(RuntimeError, match="stop"):
        tkf.reconstruct_keyframes(
            dec, unet, vae, voxel, sampler_cfg=cfg.sampler, latent_hw=LAT,
            caption_len=4, sampler_opts=dict(tgate_step=2, tgate_pab=2),
            generator=torch.Generator().manual_seed(0), device="cpu")
    assert seen["tgate_step"] == 2 and seen["tgate_pab"] == 2


def test_fast_presets_match_the_cli():
    from neurons_tpu.cli import FAST_PRESETS
    assert tcfg.FAST_PRESETS == FAST_PRESETS
    for name, preset in FAST_PRESETS.items():
        s3, s5 = tcfg.fast_options(name)
        assert s3 == {"tgate_step": preset["recon"]["tgate"],
                      "tgate_pab": preset["recon"]["tgate_pab"]}
        assert s5 == {"tgate_step": preset["video"]["tgate"],
                      "tgate_pab": preset["video"]["tgate_pab"]}
    assert tcfg.fast_options(None) == ({}, {})
