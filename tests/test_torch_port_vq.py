"""The port's regularizers and quantizers (models/vq.py) against the JAX
package on the CPU.

Codebooks and inputs are drawn so that each input's nearest code is well
separated (inputs are codes plus small noise, and a test checks the
margin): f32 rounding in z^2 + e^2 - 2 z e cannot flip an argmin between
the two frameworks. JAX's draws (the posterior noise, the remap's random
slots, the Gumbel noise) are fed to the port. Values are held at 1e-6 *
max, gradients (straight-through, against jax.grad) at 1e-5 * max, the EMA
buffers at 1e-6 * max, f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.models import vq as JV
from neurons_tpu_torch.interop.from_jax import (jax_named_tensors,
                                                load_jax_buffers,
                                                load_jax_params)
from neurons_tpu_torch.interop.torch_export import (jax_buffer_tree,
                                                    jax_tree)
from neurons_tpu_torch.models import vq as TV
from torch_port_utils import randomize, rel_err

TOL = 1e-6
GRAD_TOL = 1e-5
N_E, E_DIM = 16, 4


def _np(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def codebook(seed=0):
    return _np(seed, N_E, E_DIM)


def near_codes(book, seed, lead):
    """Inputs [*lead, E_DIM]: random codes plus noise of 0.05."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, N_E, size=lead)
    return (book[idx] + 0.05 * rng.standard_normal(lead + (E_DIM,))
            ).astype(np.float32), idx


def nchw(x):
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def test_inputs_are_well_separated():
    book = codebook()
    z, idx = near_codes(book, 1, (2, 5, 6))
    d = ((z.reshape(-1, 1, E_DIM) - book[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    assert (two[:, 1] - two[:, 0]).min() > 0.05
    np.testing.assert_array_equal(d.argmin(1), idx.reshape(-1))


def test_nearest_codes_and_perplexity_match_jax():
    book = codebook()
    z, _ = near_codes(book, 2, (40,))
    want = np.asarray(JV._nearest_codes(z, book))
    got = TV._nearest_codes(torch.from_numpy(z), torch.from_numpy(book))
    np.testing.assert_array_equal(got.numpy(), want)
    perp, use = JV.measure_perplexity(jnp.asarray(want), N_E)
    tperp, tuse = TV.measure_perplexity(got, N_E)
    np.testing.assert_allclose(float(tperp), float(perp), rtol=TOL)
    assert int(tuse) == int(use) > 1


def test_identity_regularizer():
    z = torch.randn(2, 4, 3, 3)
    out, log = TV.identity_regularizer(z)
    assert out is z and log == {}


@pytest.mark.parametrize("sample", [True, False])
def test_diagonal_gaussian_regularizer_matches_jax(sample):
    z = _np(3, 2, 8, 5, 5)
    key = jax.random.PRNGKey(4)
    want, wlog = JV.diagonal_gaussian_regularizer(jnp.asarray(z), key, sample)
    noise = np.array(jax.random.normal(key, (2, 4, 5, 5)))
    got, glog = TV.diagonal_gaussian_regularizer(
        torch.from_numpy(z), torch.from_numpy(noise), sample)
    assert rel_err(got, np.asarray(want)) <= TOL
    np.testing.assert_allclose(float(glog["kl_loss"]),
                               float(wlog["kl_loss"]), rtol=TOL)
    # no key / no noise: the mode
    mode, _ = TV.diagonal_gaussian_regularizer(torch.from_numpy(z))
    np.testing.assert_array_equal(mode.numpy(), z[:, :4])


@pytest.mark.parametrize("unknown", ["random", 7])
def test_remap_and_unmap_match_jax(unknown):
    used = np.array([3, 5, 8, 11, 13], np.int64)
    inds = np.random.default_rng(5).integers(0, 16, (4, 6))
    key = jax.random.PRNGKey(6)
    want = np.asarray(JV.remap_to_used(jnp.asarray(inds), jnp.asarray(used),
                                       unknown, key=key))
    draws = None
    if unknown == "random":  # JAX's draw, fed
        draws = torch.from_numpy(np.asarray(jax.random.randint(
            key, inds.shape, 0, used.shape[0])))
    got = TV.remap_to_used(torch.from_numpy(inds), torch.from_numpy(used),
                           unknown, draws=draws)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (~np.isin(inds, used)).any() and np.isin(inds, used).any()
    back = TV.unmap_to_all(got, torch.from_numpy(used))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JV.unmap_to_all(jnp.asarray(want),
                                                 jnp.asarray(used))))
    if unknown == "random":  # a generator's draw lands in [0, len(used))
        g = TV.remap_to_used(torch.from_numpy(inds), torch.from_numpy(used),
                             generator=torch.Generator().manual_seed(0))
        assert int(g.max()) < used.shape[0] and int(g.min()) >= 0


def _vq_pair(jmod, book):
    params = {"embedding": jnp.asarray(book)}
    tmod = TV.VectorQuantizer(jmod.n_e, jmod.e_dim, jmod.beta,
                              jmod.sane_index_shape, jmod.log_perplexity)
    load_jax_params(tmod, params)
    return params, tmod


@pytest.mark.parametrize("rank", [4, 3])
def test_vector_quantizer_matches_jax(rank):
    book = codebook(7)
    jmod = JV.VectorQuantizer(N_E, E_DIM, beta=0.3, sane_index_shape=True,
                              log_perplexity=True)
    params, tmod = _vq_pair(jmod, book)
    z, idx = near_codes(book, 8, (2, 5, 6) if rank == 4 else (2, 7))
    z = nchw(z) if rank == 4 else z
    want, wlog = jmod.apply({"params": params}, jnp.asarray(z))
    got, glog = tmod(torch.from_numpy(z))
    assert rel_err(got, np.asarray(want)) <= TOL
    assert sorted(glog) == sorted(wlog)
    np.testing.assert_array_equal(glog["min_encoding_indices"].numpy(),
                                  np.asarray(wlog["min_encoding_indices"]))
    np.testing.assert_array_equal(glog["min_encoding_indices"].numpy(), idx)
    for k in ("loss/vq", "perplexity", "cluster_usage"):
        np.testing.assert_allclose(float(glog[k]), float(wlog[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(jax_tree(tmod)["embedding"], book)
    entry = tmod.get_codebook_entry(torch.from_numpy(idx.reshape(-1)),
                                    (2, 5, 6, E_DIM) if rank == 4 else None)
    wentry = jmod.get_codebook_entry(params, jnp.asarray(idx.reshape(-1)),
                                     (2, 5, 6, E_DIM) if rank == 4 else None)
    np.testing.assert_array_equal(entry.detach().numpy(), np.asarray(wentry))


def test_vector_quantizer_straight_through_gradient_matches_jax():
    """d/dz and d/dcodebook of sum(z_q * w) + loss: the straight-through
    estimator's gradient reaches z, the codebook term reaches e."""
    book = codebook(9)
    jmod = JV.VectorQuantizer(N_E, E_DIM, beta=0.25)
    params, tmod = _vq_pair(jmod, book)
    z = nchw(near_codes(book, 10, (2, 4, 4))[0])
    w = _np(11, 2, E_DIM, 4, 4)

    def f(p, x):
        zq, log = jmod.apply({"params": p}, x)
        return jnp.sum(zq * w) + 3.0 * log["loss/vq"]

    gp, gz = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_()
    zq, log = tmod(zt)
    (torch.sum(zq * torch.from_numpy(w)) + 3.0 * log["loss/vq"]).backward()
    assert float(np.abs(np.asarray(gz)).max()) > 0
    assert rel_err(zt.grad, np.asarray(gz)) <= GRAD_TOL
    want = jax_named_tensors(tmod, jax.tree.map(np.asarray, gp))["weight"]
    assert float(want.abs().max()) > 0
    assert rel_err(tmod.weight.grad, want.numpy()) <= GRAD_TOL


@pytest.mark.parametrize("shape", [(2, 6, 3, 4), (2, 6, 2, 3, 4)],
                         ids=["4d", "5d"])
def test_vq_with_input_projection_matches_jax(shape):
    jmod = JV.VectorQuantizerWithInputProjection(6, N_E, E_DIM, beta=1.0,
                                                 output_dim=5)
    x = _np(12, *shape)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"]
    params = randomize(shapes, 13)
    params["quant"]["embedding"] = codebook(14)
    tmod = TV.VectorQuantizerWithInputProjection(6, N_E, E_DIM, 1.0, 5)
    load_jax_params(tmod, params)
    want, wlog = jmod.apply({"params": params}, x)
    got, glog = tmod(torch.from_numpy(x))
    assert got.shape == want.shape == (shape[0], 5) + shape[2:]
    assert rel_err(got, np.asarray(want)) <= 1e-5
    np.testing.assert_array_equal(glog["min_encoding_indices"].numpy(),
                                  np.asarray(wlog["min_encoding_indices"]))
    np.testing.assert_allclose(float(glog["loss/vq"]),
                               float(wlog["loss/vq"]), rtol=1e-5)


def _ema_pair(seed):
    jmod = JV.EMAVectorQuantizer(N_E, E_DIM, beta=0.25, decay=0.9)
    book = codebook(seed)
    rng = np.random.default_rng(seed + 1)
    ema = {"weight": book,
           "cluster_size": rng.random(N_E).astype(np.float32) * 3,
           "embed_avg": book * (1 + 0.1 * rng.random((N_E, 1))
                                ).astype(np.float32)}
    tmod = TV.EMAVectorQuantizer(N_E, E_DIM, 0.25, decay=0.9)
    load_jax_buffers(tmod, ema)
    return jmod, ema, tmod


@pytest.mark.parametrize("update", [True, False])
def test_ema_quantizer_matches_jax(update):
    jmod, ema, tmod = _ema_pair(15)
    z = nchw(near_codes(ema["weight"], 16, (2, 5, 5))[0])
    (want, wlog), mut = jmod.apply({"ema": ema}, jnp.asarray(z), update,
                                   mutable=["ema"])
    got, glog = tmod(torch.from_numpy(z), update=update)
    assert rel_err(got, np.asarray(want)) <= TOL
    np.testing.assert_array_equal(glog["encoding_indices"].numpy(),
                                  np.asarray(wlog["encoding_indices"]))
    for k in ("loss/vq", "perplexity"):
        np.testing.assert_allclose(float(glog[k]), float(wlog[k]),
                                   rtol=1e-5, err_msg=k)
    got_ema = jax_buffer_tree(tmod)
    for k in ("weight", "cluster_size", "embed_avg"):
        w = np.asarray(mut["ema"][k])
        assert np.abs(got_ema[k] - w).max() <= TOL * np.abs(w).max(), k
        assert np.array_equal(w, ema[k]) != update, k  # moved iff update


def test_ema_quantizer_gradient_is_straight_through():
    jmod, ema, tmod = _ema_pair(17)
    z = nchw(near_codes(ema["weight"], 18, (2, 3, 3))[0])
    w = _np(19, 2, E_DIM, 3, 3)

    def f(x):
        (zq, log), _ = jmod.apply({"ema": ema}, x, False, mutable=["ema"])
        return jnp.sum(zq * w) + log["loss/vq"]

    gz = np.asarray(jax.grad(f)(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_()
    zq, log = tmod(zt)
    (torch.sum(zq * torch.from_numpy(w)) + log["loss/vq"]).backward()
    assert rel_err(zt.grad, gz) <= GRAD_TOL


def test_ema_quantizer_process_group_sums_like_no_group(tmp_path):
    """A one-process gloo group: the all_reduce of the statistics is the
    identity, so the buffers equal those of a quantizer with no group."""
    import torch.distributed as dist
    jmod, ema, plain = _ema_pair(20)
    z = torch.from_numpy(nchw(near_codes(ema["weight"], 21, (2, 4, 4))[0]))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        grouped = TV.EMAVectorQuantizer(N_E, E_DIM, 0.25, decay=0.9,
                                        process_group=dist.group.WORLD)
        load_jax_buffers(grouped, ema)
        calls = []
        real = dist.all_reduce

        def spy(t, *a, **k):
            calls.append(tuple(t.shape))
            return real(t, *a, **k)

        dist.all_reduce = spy
        try:
            grouped(z, update=True)
        finally:
            dist.all_reduce = real
        plain(z, update=True)
    finally:
        dist.destroy_process_group()
    assert calls == [(N_E,), (N_E, E_DIM)]
    for k, v in plain.state_dict().items():
        assert torch.equal(grouped.state_dict()[k], v), k


@pytest.mark.parametrize("mode", ["train_soft", "train_hard", "eval"])
def test_gumbel_quantizer_matches_jax(mode):
    soft = mode == "train_soft"
    jmod = JV.GumbelQuantizer(6, E_DIM, N_E, straight_through=not soft,
                              kl_weight=5e-4, temp_init=0.8)
    x = _np(22, 2, 6, 4, 4)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"]
    params = randomize(shapes, 23)
    tmod = TV.GumbelQuantizer(6, E_DIM, N_E, straight_through=not soft,
                              kl_weight=5e-4, temp_init=0.8)
    load_jax_params(tmod, params)
    training = mode != "eval"
    key = jax.random.PRNGKey(24) if training else None
    want, wlog = jmod.apply({"params": params}, x, key, None, training)
    gumbel = (torch.from_numpy(np.asarray(jax.random.gumbel(
        key, (2, 4, 4, N_E)))) if training else None)
    xt = torch.from_numpy(x).requires_grad_()
    got, glog = tmod(xt, gumbel, None, training)
    assert rel_err(got, np.asarray(want)) <= 1e-5
    np.testing.assert_array_equal(glog["indices"].numpy(),
                                  np.asarray(wlog["indices"]))
    np.testing.assert_allclose(float(glog["loss/vq"]), float(wlog["loss/vq"]),
                               rtol=1e-5)
    if mode == "eval":  # hard one-hot codes: z_q is a row of the codebook
        rows = tmod.embed.detach()[glog["indices"]].permute(0, 3, 1, 2)
        assert torch.allclose(got.detach(), rows, atol=1e-6)
    w = _np(25, 2, E_DIM, 4, 4)

    def f(xx):
        zq, log = jmod.apply({"params": params}, xx, key, None, training)
        return jnp.sum(zq * w) + log["loss/vq"]

    gx = np.asarray(jax.grad(f)(jnp.asarray(x)))
    (torch.sum(got * torch.from_numpy(w)) + glog["loss/vq"]).backward()
    assert float(np.abs(gx).max()) > 0
    assert rel_err(xt.grad, gx) <= GRAD_TOL
