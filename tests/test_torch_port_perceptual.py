"""The port's LPIPS, PatchGAN discriminator and GAN losses against the JAX
package on the CPU (training/perceptual.py), and their importers.

Every JAX leaf is drawn from numpy (`torch_port_utils.randomize`) and
carried into the port. The discriminator's BatchNorm is held to flax's in
train mode (batch statistics; the running ones moved with momentum 0.9 and
the biased batch variance) and in eval mode (the running ones). Outputs
are held at 1e-5 * max, the running statistics at 1e-6 * max, the losses
at 1e-6 relative, f32. The importers are held to the JAX importers on
synthetic state dicts in the reference layouts, written by the port's
exporters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.interop import torch_import as jti
from neurons_tpu.training import perceptual as JP
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop.from_jax import (jax_named_tensors,
                                                load_jax_buffers,
                                                load_jax_params)
from neurons_tpu_torch.training import perceptual as TP
from torch_port_utils import randomize, rel_err

TOL = 1e-5
STATS_TOL = 1e-6
LOSS_TOL = 1e-6


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _stats(variables, seed):
    rng = np.random.default_rng(seed)
    return {bn: {"mean": 0.1 * rng.standard_normal(v["mean"].shape
                                                   ).astype(np.float32),
                 "var": (0.5 + rng.random(v["var"].shape)).astype(np.float32)}
            for bn, v in variables["batch_stats"].items()}


@pytest.fixture(scope="module")
def lpips_pair():
    x = jnp.zeros((1, 3, 32, 32))
    params = randomize(jax.eval_shape(JP.LPIPS().init, jax.random.PRNGKey(0),
                                      x, x)["params"], 3)
    mod = TP.LPIPS()
    load_jax_params(mod, params)
    return params, mod


def test_lpips_matches_jax(lpips_pair):
    params, mod = lpips_pair
    x, y = _np(1, 2, 3, 32, 32), _np(2, 2, 3, 32, 32)
    want = np.asarray(JP.LPIPS().apply({"params": params}, x, y))
    got = mod(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (2, 1, 1, 1) and float(np.abs(want).min()) > 0
    assert rel_err(got, want) <= TOL
    assert float(mod(torch.from_numpy(x), torch.from_numpy(x)).abs().max()
                 ) <= 1e-7
    assert not any(p.requires_grad for p in mod.parameters())


def test_lpips_passes_gradients_to_its_input(lpips_pair):
    params, mod = lpips_pair
    x, y = _np(3, 2, 3, 32, 32), _np(4, 2, 3, 32, 32)
    want = np.asarray(jax.grad(lambda a: JP.LPIPS().apply(
        {"params": params}, a, y).sum())(x))
    xt = torch.from_numpy(x).requires_grad_()
    mod(xt, torch.from_numpy(y)).sum().backward()
    assert float(np.abs(want).max()) > 0
    assert rel_err(xt.grad, want) <= 1e-4
    assert all(p.grad is None for p in mod.parameters())


@pytest.fixture(scope="module")
def disc_pair():
    x = jnp.zeros((1, 3, 32, 32))
    jmod = JP.NLayerDiscriminator(ndf=8, n_layers=3)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)
    variables = {"params": randomize(shapes["params"], 5),
                 "batch_stats": _stats(shapes, 6)}
    tmod = TP.NLayerDiscriminator(ndf=8, n_layers=3)
    load_jax_params(tmod, variables["params"])
    load_jax_buffers(tmod, variables["batch_stats"])
    return jmod, variables, tmod


def _assert_stats(tmod, want):
    got = tex.jax_buffer_tree(tmod)
    assert set(got) == set(want)
    for bn in want:
        for leaf in ("mean", "var"):
            w = np.asarray(want[bn][leaf])
            err = np.abs(got[bn][leaf] - w).max() / np.abs(w).max()
            assert err <= STATS_TOL, (bn, leaf, err)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator_matches_flax(disc_pair, train):
    jmod, variables, tmod = disc_pair
    x = _np(7, 2, 3, 32, 32)
    if train:
        want, mut = jmod.apply(variables, x, train=True,
                               mutable=["batch_stats"])
    else:
        want, mut = jmod.apply(variables, x, train=False), variables
    stats = {k: v.clone() for k, v in tmod.state_dict().items()}
    try:
        got = tmod(torch.from_numpy(x), train=train)
        assert got.shape == (2, 1, 2, 2)
        assert rel_err(got, np.asarray(want)) <= TOL
        # the running statistics: flax's momentum 0.9, the biased variance
        _assert_stats(tmod, mut["batch_stats"])
        if train:
            bs = mut["batch_stats"]["bn_1"]["var"]
            assert not np.allclose(bs, variables["batch_stats"]["bn_1"]["var"])
    finally:
        tmod.load_state_dict(stats)


def test_discriminator_batch_statistics_without_update(disc_pair):
    """The generator pass's mode: batch statistics, running ones kept."""
    jmod, variables, tmod = disc_pair
    x = _np(8, 2, 3, 32, 32)
    want, _ = jmod.apply(variables, x, train=True, mutable=["batch_stats"])
    got = tmod(torch.from_numpy(x), train=True, update_stats=False)
    assert rel_err(got, np.asarray(want)) <= TOL
    _assert_stats(tmod, variables["batch_stats"])


def test_discriminator_gradients_match_flax(disc_pair):
    """Train mode differentiates through the batch statistics."""
    jmod, variables, tmod = disc_pair
    x = _np(9, 2, 3, 32, 32)

    def f(p, a):
        out, _ = jmod.apply({"params": p,
                             "batch_stats": variables["batch_stats"]}, a,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out ** 2)

    gp, gx = jax.grad(f, argnums=(0, 1))(variables["params"], x)
    want = jax_named_tensors(tmod, jax.tree.map(np.asarray, gp))
    xt = torch.from_numpy(x).requires_grad_()
    (tmod(xt, train=True, update_stats=False) ** 2).sum().backward()
    try:
        assert rel_err(xt.grad, np.asarray(gx)) <= 1e-4
        for name, p in tmod.named_parameters():
            assert float(want[name].abs().max()) > 0, name
            assert rel_err(p.grad, want[name].numpy()) <= 1e-4, name
    finally:
        tmod.zero_grad(set_to_none=True)


def test_d_losses_match_jax():
    lr, lf = _np(10, 2, 1, 6, 6), _np(11, 2, 1, 6, 6)
    for jf, tf in ((JP.hinge_d_loss, TP.hinge_d_loss),
                   (JP.vanilla_d_loss, TP.vanilla_d_loss)):
        want = float(jf(lr, lf))
        got = float(tf(torch.from_numpy(lr), torch.from_numpy(lf)))
        assert want != 0.0
        np.testing.assert_allclose(got, want, rtol=LOSS_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_nll_from_rec_matches_jax(weighted):
    rec = np.abs(_np(12, 2, 3, 8, 8))
    w = np.abs(_np(13, 2, 3, 8, 8)) if weighted else None
    want = JP.nll_from_rec(rec, jnp.float32(0.3), w)
    got = TP.nll_from_rec(torch.from_numpy(rec), torch.tensor(0.3),
                          None if w is None else torch.from_numpy(w))
    for g, x in zip(got, want):
        np.testing.assert_allclose(float(g), float(x), rtol=LOSS_TOL)


@pytest.mark.parametrize("scale", [1.0, 1e-9, 1e9],
                         ids=["plain", "g_tiny", "g_huge"])
def test_adaptive_weight_matches_jax(scale):
    """The clip to [0, 1e4] included (g_tiny); detached."""
    a, b = _np(14, 3, 8, 3, 3), _np(15, 3, 8, 3, 3, scale=scale)
    want = float(JP.adaptive_weight(a, b, 0.5))
    bt = torch.from_numpy(b).requires_grad_()
    got = TP.adaptive_weight(torch.from_numpy(a), bt, 0.5)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), want, rtol=LOSS_TOL)


def test_flatten_video_matches_jax():
    v = _np(16, 2, 3, 4, 5, 6)
    want = np.asarray(JP.flatten_video(v))
    got = TP.flatten_video(torch.from_numpy(v))
    assert got.shape == (8, 3, 5, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    img = _np(17, 2, 3, 5, 6)
    assert TP.flatten_video(torch.from_numpy(img)).shape == img.shape


def _fixed_apply(seed):
    w = _np(seed, 3)

    def j(a):  # squared: logits whose mean does not cancel
        return jnp.einsum("bchw,c->bhw", a, w)[:, None] ** 2 - 0.5

    def t(a):
        return torch.einsum("bchw,c->bhw", a,
                            torch.from_numpy(w))[:, None] ** 2 - 0.5

    return j, t


@pytest.mark.parametrize("video", [False, True], ids=["image", "video"])
def test_generator_and_discriminator_loss_match_jax(video, lpips_pair):
    params, mod = lpips_pair
    shape = (2, 3, 2, 16, 16) if video else (2, 3, 16, 16)
    x, r = _np(18, *shape), _np(19, *shape)
    jd, td = _fixed_apply(20)
    grads = (_np(21, 4, 4), _np(22, 4, 4))
    reg = {"kl_loss": np.float32(3.5)}
    kw = dict(perceptual_weight=1.0, disc_factor=0.7, disc_weight=0.5,
              regularization_weights={"kl_loss": 1e-3})
    want, wlog = JP.generator_loss(
        x, r, lpips_apply=lambda a, b: JP.LPIPS().apply({"params": params},
                                                        a, b),
        disc_apply=jd, logvar=jnp.float32(0.2), last_layer_grads=grads,
        regularization_log=reg, **kw)
    got, glog = TP.generator_loss(
        torch.from_numpy(x), torch.from_numpy(r), lpips_apply=mod,
        disc_apply=td, logvar=torch.tensor(0.2),
        last_layer_grads=tuple(map(torch.from_numpy, grads)),
        regularization_log={"kl_loss": torch.tensor(3.5)}, **kw)
    assert sorted(glog) == sorted(wlog)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for k in wlog:
        np.testing.assert_allclose(float(glog[k]), float(wlog[k]),
                                   rtol=1e-5, err_msg=k)
    dw, dlog = JP.discriminator_loss(x, r, disc_apply=jd, disc_factor=0.7)
    dg, dglog = TP.discriminator_loss(torch.from_numpy(x), torch.from_numpy(r),
                                      disc_apply=td, disc_factor=0.7)
    np.testing.assert_allclose(float(dg), float(dw), rtol=LOSS_TOL)
    for k in dlog:
        np.testing.assert_allclose(float(dglog[k]), float(dlog[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_generator_loss_last_layer_takes_autograd_grads():
    """`last_layer`: the two gradients by autograd.grad over one forward
    equal the ones passed in as `last_layer_grads`."""
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    x = torch.randn(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    r = torch.einsum("oc,bchw->bohw", w, torch.ones(2, 3, 8, 8))[:, :3]

    def disc(a):
        return a.mean(dim=1, keepdim=True) ** 2

    kw = dict(lpips_apply=None, disc_apply=disc, logvar=torch.tensor(0.0),
              perceptual_weight=0.0)
    _, log = TP.generator_loss(x, r, last_layer=w, **kw)
    rec = torch.abs(x - r)
    nll = torch.sum(rec) / 2
    g = -torch.mean(disc(r))
    grads = [torch.autograd.grad(t, w, retain_graph=True)[0]
             for t in (nll, g)]
    _, want = TP.generator_loss(x, r, last_layer_grads=tuple(grads), **kw)
    assert float(log["scalars/d_weight"]) == float(want["scalars/d_weight"])
    assert float(log["scalars/d_weight"]) > 0
    assert w.grad is None


@pytest.fixture(scope="module")
def lpips_sd(lpips_pair):
    _, mod = lpips_pair
    return tex.to_torch(tex.lpips_state_dict(tex.jax_tree(mod)))


def test_import_lpips_matches_jax(lpips_sd, lpips_pair):
    want, wunused = jti.import_lpips(lpips_sd)
    got, unused = TP.import_lpips(lpips_sd)
    assert unused == wunused == []
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # and back into a fresh module: the same outputs
    mod = TP.LPIPS()
    load_jax_params(mod, got)
    x, y = torch.from_numpy(_np(23, 1, 3, 32, 32)), torch.from_numpy(
        _np(24, 1, 3, 32, 32))
    assert torch.equal(mod(x, y), lpips_pair[1](x, y))


def test_import_nlayer_discriminator_matches_jax(disc_pair):
    _, variables, tmod = disc_pair
    sd = tex.to_torch(tex.nlayer_discriminator_state_dict(
        tex.jax_tree(tmod), tex.jax_buffer_tree(tmod), n_layers=3))
    want, wunused = jti.import_nlayer_discriminator(sd, 3)
    got, unused = TP.import_nlayer_discriminator(sd, 3)
    assert unused == wunused == []
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(variables["params"])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got["batch_stats"]),
                    jax.tree.leaves(variables["batch_stats"])):
        np.testing.assert_array_equal(a, b)
    # a torch BatchNorm2d-layout file reads into the port's BatchNorm
    fresh = TP.NLayerDiscriminator(ndf=8, n_layers=3)
    load_jax_params(fresh, got["params"])
    load_jax_buffers(fresh, got["batch_stats"])
    for k, v in tmod.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_load_jax_buffers_is_strict(disc_pair):
    _, variables, _ = disc_pair
    fresh = TP.NLayerDiscriminator(ndf=8, n_layers=3)
    partial = {k: v for k, v in variables["batch_stats"].items()
               if k != "bn_2"}
    with pytest.raises(ValueError, match="unfilled"):
        load_jax_buffers(fresh, partial)
    extra = dict(variables["batch_stats"], bn_9={"mean": np.zeros(1)})
    with pytest.raises(ValueError, match="unused"):
        load_jax_buffers(fresh, extra)
