"""The port's stage-3 and stage-5 samplers in bf16 against the JAX
package's in bf16, on the tiny configs.

The card runs every model in bf16 (`chip_smoke.py:build_clip`), so the
f32 parity tests do not cover the path users run. Here the tiny
`unclip_sample` (exact and TGATE) and the tiny `reconstruct_video` (exact
and TGATE, with SparseCtrl) run in both packages with the same weights
rounded to bf16, modules in bf16 and the sampler state in f32: the JAX
package as bench.py runs it (parameters cast to bf16, each module's
floating inputs cast to bf16 and its output back to f32), the port with
its modules converted to bf16. Each is measured against the JAX package's
f32 run on the same weights and draws; the port's error may be at most
twice the JAX package's bf16 error, plus 1e-2 * max |f32|: the two
frameworks round different intermediates to bf16 (PyTorch's CPU bf16
matmul and layer norm keep other intermediates than XLA's), so their
bf16 errors are of one order, not equal.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.models.unet2d import precompute_context_kv as jkv
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu.pipelines import keyframe as jkf
from neurons_tpu.pipelines import video as jvideo
from neurons_tpu_torch.pipelines import keyframe as tkf
from neurons_tpu_torch.pipelines.video import reconstruct_video
from test_torch_port_fastpath_keyframe import (KEY, LAT, STEPS,
                                               unclip_draws)
from test_torch_port_fastpath_keyframe import one_thread  # noqa: F401
from test_torch_port_fastpath_keyframe import parts  # noqa: F401 fixture
from test_torch_port_fastpath_video import B as VB
from test_torch_port_fastpath_video import F, HW
from test_torch_port_fastpath_video import KEY as VKEY
from test_torch_port_fastpath_video import nets  # noqa: F401 fixture
from torch_port_utils import t

BF16 = jnp.bfloat16


def _cast(tree, dtype):
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), tree)


def _f32(x):
    return x.astype(jnp.float32)


def _port_bf16(*modules):
    return [copy.deepcopy(m).to(torch.bfloat16) for m in modules]


def _errors(port, jax_bf16, jax_f32):
    ref = np.asarray(jax_f32, np.float64)
    scale = np.abs(ref).max()
    port_err = np.abs(port.double().numpy() - ref).max() / scale
    jax_err = np.abs(np.asarray(jax_bf16, np.float64) - ref).max() / scale
    return port_err, jax_err


# --- stage 3 ---------------------------------------------------------------

def jax_unclip(p, dtype, **opts):
    """The JAX package's unclip_sample with its modules in `dtype`, as
    bench.py:226-243 wraps them."""
    uparams, vparams = _cast(p.uparams, dtype), _cast(p.vparams, dtype)

    def unet_apply(params, x, tt, ctx, vec, **kw):
        out = p.junet.apply({"params": params}, x.astype(dtype), tt,
                            ctx.astype(dtype), vec.astype(dtype), **kw)
        return ((_f32(out[0]),) + out[1:] if isinstance(out, tuple)
                else _f32(out))

    def vae_decode(z):
        return _f32(p.jvae.apply({"params": vparams}, z.astype(dtype),
                                 method=JVAE.decode))

    run = jax.jit(lambda up, tokens: jkf.unclip_sample(
        unet_apply, up, vae_decode, KEY, tokens, num_steps=STEPS,
        latent_hw=LAT,
        precompute_kv=lambda pp, c: jkv(pp, c.astype(dtype), p.ucfg),
        **opts))
    return run(uparams, jnp.asarray(p.tokens))


@pytest.mark.parametrize("opts", [{}, {"tgate_step": 3}],
                         ids=["exact", "tgate"])
def test_unclip_sample_bf16(parts, opts):  # noqa: F811
    ref = jax_unclip(parts, jnp.float32, **opts)
    jref = jax_unclip(parts, BF16, **opts)
    unet, vae = _port_bf16(parts.tunet, parts.tvae)
    got = tkf.unclip_sample(unet, vae, t(parts.tokens), num_steps=STEPS,
                            latent_hw=LAT, noise=unclip_draws(), **opts)
    assert got.dtype == torch.float32
    port_err, jax_err = _errors(got, jref, ref)
    print(f"unclip_sample {opts}: port bf16 {port_err:.3e}, JAX bf16 "
          f"{jax_err:.3e}")
    assert jax_err > 0 and port_err <= 2 * jax_err + 1e-2


# --- stage 5 ---------------------------------------------------------------

def jax_video_in(n, dtype, **opts):
    """The JAX package's reconstruct_video with its modules in `dtype`, as
    bench.py:296-331 wraps them."""
    cast = _cast((n.uparams, n.cparams, n.vparams), dtype)

    def u3(p, x, tt, c, down, mid, **kw):
        out = n.u3_apply(p, x.astype(dtype), tt, c.astype(dtype), down, mid,
                         **kw)
        return ((_f32(out[0]),) + out[1:] if isinstance(out, tuple)
                else _f32(out))

    def cna(p, x, tt, c, cond, mask, scale):
        return n.cn_apply[False](p, x.astype(dtype), tt, c.astype(dtype),
                                 cond.astype(dtype), mask.astype(dtype),
                                 scale)

    @jax.jit
    def run(uparams, cparams, vparams):
        return jvideo.reconstruct_video(
            unet3d_apply=u3, unet3d_params=uparams,
            controlnet_apply=cna, controlnet_params=cparams,
            vae_encode_mode=lambda x: _f32(n.vae_encode(vparams,
                                                        x.astype(dtype))),
            vae_decode=lambda z: _f32(n.vae_decode(vparams,
                                                   z.astype(dtype))),
            key=VKEY, blurry_video=n.blurry, keyframe=n.keyframe,
            text_embeddings=n.text, uncond_embeddings=n.uncond,
            num_steps=STEPS, n_frames=F, **opts)

    return run(*cast)


@pytest.mark.parametrize("opts", [{}, {"tgate_step": 2}],
                         ids=["exact", "tgate"])
def test_reconstruct_video_bf16(nets, opts):  # noqa: F811
    ref = jax_video_in(nets, jnp.float32, **opts)
    jref = jax_video_in(nets, BF16, **opts)
    unet3d, cn, vae = _port_bf16(nets.tunet, nets.tcn, nets.tvae)
    noise = t(jax.random.normal(VKEY, (VB, 4, F, HW, HW)))
    got = reconstruct_video(unet3d, cn, vae, t(nets.blurry),
                            t(nets.keyframe), t(nets.text), t(nets.uncond),
                            num_steps=STEPS, n_frames=F, noise=noise,
                            device="cpu", **opts)
    for name in ("latents", "video"):
        port_err, jax_err = _errors(getattr(got, name), getattr(jref, name),
                                    getattr(ref, name))
        print(f"reconstruct_video {opts} {name}: port bf16 {port_err:.3e}, "
              f"JAX bf16 {jax_err:.3e}")
        assert jax_err > 0 and port_err <= 2 * jax_err + 1e-2, name
