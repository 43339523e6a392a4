"""The port's sgm autoencoder trainer against the JAX package on the CPU.

A tiny `AutoencodingEngine` (a two-level VAE at 32 px: the mid attention
runs over 16 x 16 = 256 tokens, so it takes `dot_product_attention`'s
differentiable flash path, whose plain versions serve the CPU) in two
configurations: KL with a learned logvar and LPIPS on, and VQ. Every leaf
of the JAX state (the VAE, the quantizer, the discriminator and its
running statistics, LPIPS) is drawn from numpy and carried into the port,
and JAX's posterior noise is fed to the port.

Both engines take their steps with a gradient recorder in place of Adam
(optax: a transformation whose state is the gradient and whose update is
zero; the port: an optimizer that keeps each .grad), so no parameter
moves and each step starts from the same state in both: d (before
disc_start, gated), g (the GAN term gated), g (live) and d (live). Losses
and logs are held at 1e-5 relative, the gradients at 2e-4 of each
tensor's max (a floor of 1e-3 of the module's largest gradient for
tensors whose gradient vanishes in exact arithmetic, such as a bias a
GroupNorm removes; an attention's key bias, whose gradient is rounding
noise, at 1e-6 of the module's largest), the running statistics at 1e-5
of max after every step. Adam itself is held to optax.adam(b1=0.5, b2=0.9) on the same
gradients, and the real steps' gate and learning are tested on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neurons_tpu.config import VAEConfig as JVAEConfig
from neurons_tpu.training import train_autoencoder as jta
from neurons_tpu_torch.config import VAEConfig
from neurons_tpu_torch.interop.from_jax import (jax_named_tensors,
                                                load_jax_buffers,
                                                load_jax_params)
from neurons_tpu_torch.interop.torch_export import jax_buffer_tree
from neurons_tpu_torch.ops import attention as attn
from neurons_tpu_torch.training import train_autoencoder as tta
from torch_port_utils import randomize

LOSS_TOL = 1e-5
GRAD_TOL = 2e-4
GRAD_FLOOR = 1e-3
STATS_TOL = 1e-5
# softmax is invariant to a key bias: its gradient is rounding noise in
# both frameworks, held at 1e-6 of the module's largest gradient
VANISHING = ("mid_attn.k.bias",)
VANISHING_TOL = 1e-6
HW, BATCH = 32, 2
VAE = dict(block_out_channels=(8, 8), layers_per_block=1, norm_num_groups=4,
           latent_channels=4)
COMMON = dict(disc_start=1, disc_ndf=8, disc_num_layers=2, lr=1e-3)
CONFIGS = {
    "kl_logvar": dict(regularizer="kl", learn_logvar=True,
                      perceptual_weight=1.0),
    "vq": dict(regularizer="vq", n_codes=16, perceptual_weight=0.0),
}
STEPS = ("d_gated", "g_gated", "g_live", "d_live")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_recorder():
    """An optax transformation that keeps the gradient as its state and
    moves nothing."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


class GradRecorder(torch.optim.Optimizer):
    """Keeps each parameter's .grad at `step`; moves nothing."""

    def __init__(self, params):
        super().__init__(params, {})
        self.grads = {}

    def step(self, closure=None):
        self.grads = {id(p): p.grad.detach().clone()
                      for g in self.param_groups for p in g["params"]}


def configs(name):
    kw = dict(COMMON, **CONFIGS[name])
    return (jta.AutoencoderTrainConfig(vae=JVAEConfig(**VAE), **kw),
            tta.AutoencoderTrainConfig(vae=VAEConfig(**VAE), **kw))


def jax_state(name, jeng):
    """The JAX state with every leaf drawn from numpy; the VQ codebook
    spread so that each latent's nearest code is well separated."""
    state = jeng.init(jax.random.PRNGKey(0), image_hw=HW)
    seed = {"kl_logvar": 1, "vq": 2}[name]
    for k in ("vae", "disc", "quant"):
        if k in state:
            state[k] = randomize(state[k], seed + 10 * len(k))
    rng = np.random.default_rng(seed)
    state["disc_stats"] = {
        bn: {"mean": 0.1 * rng.standard_normal(v["mean"].shape,
                                               dtype=np.float32),
             "var": (0.5 + rng.random(v["var"].shape)).astype(np.float32)}
        for bn, v in state["disc_stats"].items()}
    state["logvar"] = np.float32(0.05)
    if "quant" in state:  # a seed whose codes are well separated
        shape = state["quant"]["embedding"].shape
        state["quant"]["embedding"] = 2.0 * np.random.default_rng(
            166).standard_normal(shape, dtype=np.float32)
    if jeng.lpips is not None:
        jeng.lpips_params = randomize(jeng.lpips_params, seed + 7)
    state = jax.tree.map(jnp.asarray, state)
    state["step"] = jnp.zeros((), jnp.int32)
    return state


def carry(jstate, tstate):
    """The JAX state's leaves into the port's modules."""
    load_jax_params(tstate.vae, jax.tree.map(np.asarray, jstate["vae"]))
    load_jax_params(tstate.disc, jax.tree.map(np.asarray, jstate["disc"]))
    load_jax_buffers(tstate.disc,
                     jax.tree.map(np.asarray, jstate["disc_stats"]))
    if tstate.quant is not None:
        load_jax_params(tstate.quant,
                        jax.tree.map(np.asarray, jstate["quant"]))
    with torch.no_grad():
        tstate.logvar.copy_(torch.tensor(float(jstate["logvar"])))


def as_port(module, tree):
    """A JAX gradient tree as {port parameter name: tensor}."""
    return jax_named_tensors(module, jax.tree.map(np.asarray, tree))


class Spy:
    """Counts the flash paths the port's VAE attention takes."""

    def __init__(self, monkeypatch):
        self.calls = {"flash_attention": 0, "flash_attention_fwd": 0,
                      "flash_attention_bwd": 0}
        for name in self.calls:
            fn = getattr(attn, name)
            monkeypatch.setattr(attn, name, self.wrap(name, fn))

    def wrap(self, name, fn):
        def inner(*a, **k):
            self.calls[name] += 1
            return fn(*a, **k)
        return inner


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    """Both engines through d, g, g, d with gradient recorders; each
    step's loss, log, gradients and running statistics."""
    name = request.param
    jcfg, tcfg = configs(name)
    jeng = jta.AutoencodingEngine(jcfg)
    jeng.opt_g = jeng.opt_d = jax_recorder()
    js = jax_state(name, jeng)
    torch.manual_seed(0)
    teng = tta.AutoencodingEngine(tcfg, lpips_params=(
        None if jeng.lpips is None
        else jax.tree.map(np.asarray, jeng.lpips_params)))
    ts = teng.init("cpu")
    carry(js, ts)
    ts.opt_g = GradRecorder(ts.gen_params())
    ts.opt_d = GradRecorder(list(ts.disc.parameters()))

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.uniform(-1, 1, (BATCH, 3, HW, HW)).astype(np.float32))
    xt = torch.from_numpy(np.array(x))
    jg, jd = jeng.make_generator_step(), jeng.make_discriminator_step()
    tg, td = teng.make_generator_step(), teng.make_discriminator_step()
    mp = pytest.MonkeyPatch()
    spy = Spy(mp)
    out = {"name": name, "state": ts, "jstate0": js, "x": xt,
           "jcfg": jcfg}
    try:
        for i, kind in enumerate(STEPS):
            key = jax.random.PRNGKey(100 + i)
            lat = (BATCH, VAE["latent_channels"], HW // 2, HW // 2)
            noise = (jax.random.normal(key, lat)
                     if jcfg.regularizer == "kl" else None)
            before = dict(spy.calls)
            if kind[0] == "g":
                js, jloss, jlog = jg(js, x, key)
                ts, tloss, tlog = tg(ts, xt, None if noise is None else
                                     torch.from_numpy(np.array(noise)))
                jgrads, tgrads = js["opt_g"], ts.opt_g.grads
            else:
                js, jloss, jlog = jd(js, x, key)
                ts, tloss, tlog = td(ts, xt, None if noise is None else
                                     torch.from_numpy(np.array(noise)))
                jgrads, tgrads = js["opt_d"], ts.opt_d.grads
            out[kind] = dict(
                jloss=float(jloss), tloss=float(tloss),
                jlog={k: np.asarray(v) for k, v in jlog.items()},
                tlog={k: v.numpy() for k, v in tlog.items()},
                jgrads=jax.tree.map(np.asarray, jgrads), tgrads=tgrads,
                jstats=jax.tree.map(np.asarray, js["disc_stats"]),
                tstats=jax_buffer_tree(ts.disc),
                jstep=int(js["step"]), tstep=ts.step,
                calls={k: v - before[k] for k, v in spy.calls.items()})
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", STEPS)
def test_step_loss_and_log_match_jax(run, kind):
    r = run[kind]
    assert r["tloss"] != 0.0
    np.testing.assert_allclose(r["tloss"], r["jloss"], rtol=LOSS_TOL)
    assert sorted(r["tlog"]) == sorted(r["jlog"])
    for k, want in r["jlog"].items():
        np.testing.assert_allclose(r["tlog"][k], want, rtol=LOSS_TOL,
                                   atol=1e-7, err_msg=k)
    assert r["tstep"] == r["jstep"]


def _grad_errors(module, jtree, tgrads):
    want = as_port(module, jtree)
    named = dict(module.named_parameters())
    assert set(want) == set(named)
    scale = max(float(w.abs().max()) for w in want.values())
    assert scale > 0
    errs = {}
    for name, w in want.items():
        got = tgrads[id(named[name])]
        if name.endswith(VANISHING):  # rounding noise in both: vs the scale
            errs[name] = (float((got - w).abs().max()) / scale
                          * GRAD_TOL / VANISHING_TOL)
            continue
        denom = max(float(w.abs().max()), GRAD_FLOOR * scale)
        errs[name] = float((got - w).abs().max()) / denom
    return errs, want, scale


def assert_codes_well_separated(ts, x):
    """The premise of the VQ comparison: no latent sits near a tie between
    two codes, so f32 rounding cannot flip an argmin; many codes in use."""
    with torch.no_grad():
        z = ts.vae.encode(x).mean.permute(0, 2, 3, 1).reshape(-1, 4)
        d = torch.cdist(z, ts.quant.weight) ** 2
        two = d.topk(2, largest=False).values
    gap = float((two[:, 1] - two[:, 0]).min())
    assert gap > 1e-3 * float(two[:, 0].max()), gap
    assert len(set(d.argmin(dim=1).tolist())) > 4


@pytest.mark.parametrize("kind", ["g_gated", "g_live"])
def test_generator_gradients_match_jax(run, kind):
    r, ts = run[kind], run["state"]
    errs, want, scale = _grad_errors(ts.vae, r["jgrads"]["vae"], r["tgrads"])
    bad = {k: e for k, e in errs.items() if e > GRAD_TOL}
    assert not bad, bad
    # not vacuous: a gradient reaches every module of the VAE's path
    live = [k for k, w in want.items() if float(w.abs().max()) > 1e-3 * scale]
    assert len(live) > 0.5 * len(want)
    for mod in ("encoder.conv_in", "encoder.mid_attn.q",
                "decoder.mid_attn.v", "decoder.conv_out", "quant_conv",
                "post_quant_conv"):
        assert any(k.startswith(mod) for k in live), mod
    if ts.quant is not None:
        assert_codes_well_separated(ts, run["x"])
        w = as_port(ts.quant, r["jgrads"]["quant"])["weight"]
        got = r["tgrads"][id(ts.quant.weight)]
        assert float(w.abs().max()) > 0
        assert float((got - w).abs().max()) <= GRAD_TOL * float(
            w.abs().max())
    if run["jcfg"].learn_logvar:
        w = float(r["jgrads"]["logvar"])
        got = float(r["tgrads"][id(ts.logvar)])
        assert w != 0.0
        np.testing.assert_allclose(got, w, rtol=GRAD_TOL)


def test_discriminator_gradients_match_jax(run):
    r, ts = run["d_live"], run["state"]
    errs, want, scale = _grad_errors(ts.disc, r["jgrads"], r["tgrads"])
    assert max(errs.values()) <= GRAD_TOL, errs
    assert all(float(w.abs().max()) > 0 for w in want.values())
    # gated: JAX's recorded gradients are the gated ones, zeros
    gated = run["d_gated"]
    assert all(float(np.abs(g).max()) == 0
               for g in jax.tree.leaves(gated["jgrads"]))
    assert all(float(g.abs().max()) == 0 for g in gated["tgrads"].values())


@pytest.mark.parametrize("kind", STEPS)
def test_running_statistics_match_flax(run, kind):
    r = run[kind]
    for bn, want in r["jstats"].items():
        for leaf in ("mean", "var"):
            got, w = r["tstats"][bn][leaf], want[leaf]
            err = np.abs(got - w).max() / np.abs(w).max()
            assert err <= STATS_TOL, (bn, leaf, err)
    # the generator pass leaves them as they were; a d-step moves them
    prev = run["jstate0"]["disc_stats"] if kind == "d_gated" else None
    if kind == "d_gated":
        moved = any(not np.array_equal(np.asarray(prev[bn]["var"]),
                                       r["jstats"][bn]["var"])
                    for bn in prev)
        assert moved
    if kind.startswith("g"):
        before = run[STEPS[STEPS.index(kind) - 1]]["tstats"]
        for bn in before:
            for leaf in ("mean", "var"):
                assert np.array_equal(before[bn][leaf],
                                      r["tstats"][bn][leaf])


@pytest.mark.parametrize("kind", STEPS)
def test_vae_attention_takes_the_flash_path(run, kind):
    calls = run[kind]["calls"]
    if kind[0] == "g":  # the encoder's and the decoder's mid attention
        assert calls == {"flash_attention": 2, "flash_attention_fwd": 2,
                         "flash_attention_bwd": 2}
    else:  # the reconstruction under no_grad
        assert calls == {"flash_attention": 0, "flash_attention_fwd": 2,
                         "flash_attention_bwd": 0}


def test_adam_matches_optax_on_equal_gradients(run):
    """torch.optim.Adam(betas=(0.5, 0.9), eps=1e-8) against optax.adam
    (b1=0.5, b2=0.9) on the recorded JAX gradients fed to both, 3 steps."""
    grads = as_port(run["state"].vae, run["g_live"]["jgrads"]["vae"])
    names = sorted(grads)
    # parameters from 0, so each holds the sum of its updates (no
    # rounding of a large value hides the update's own)
    p0 = {n: np.zeros(tuple(grads[n].shape), np.float32) for n in names}
    opt = optax.adam(1e-3, b1=0.5, b2=0.9)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    jo = opt.init(jp)
    tp = [torch.tensor(p0[n], requires_grad=True) for n in names]
    to = tta._adam(tp, 1e-3)
    for i in range(3):
        g = {n: grads[n].numpy() * (1.0 + 0.5 * i) for n in names}
        upd, jo = opt.update({n: jnp.asarray(v) for n, v in g.items()}, jo,
                             jp)
        jp = optax.apply_updates(jp, upd)
        for p, n in zip(tp, names):
            p.grad = torch.from_numpy(g[n])
        to.step()
    for p, n in zip(tp, names):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   rtol=0, atol=1e-5 * 1e-3, err_msg=n)
        assert float(p.detach().abs().max()) > 0
    assert tta.adam_count(to) == 3


def _real_engine(name, disc_start):
    _, tcfg = configs(name)
    tcfg.disc_start = disc_start
    torch.manual_seed(4)
    eng = tta.AutoencodingEngine(tcfg)
    return eng, eng.init("cpu")


def _x():
    g = torch.Generator().manual_seed(6)
    return torch.rand((BATCH, 3, HW, HW), generator=g) * 2 - 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_disc_gate_steps_adam_without_moving(name):
    """Before disc_start, with the real Adams: the discriminator step
    zeroes its gradients and still steps Adam (its count advances), so no
    parameter moves, in both packages; the running statistics still move
    and the step counter does not."""
    eng, st = _real_engine(name, disc_start=1000)
    jcfg, _ = configs(name)
    jcfg.disc_start = 1000
    jeng = jta.AutoencodingEngine(jcfg)
    js = jeng.init(jax.random.PRNGKey(0), image_hw=HW)
    jnew, jd, _ = jeng.make_discriminator_step()(
        js, jnp.asarray(_x().numpy()), jax.random.PRNGKey(1))
    assert int(jnew["opt_d"][0].count) == 1
    for a, b in zip(jax.tree.leaves(js["disc"]), jax.tree.leaves(jnew["disc"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert float(jd) > 0 and int(jnew["step"]) == 0
    before = {k: v.detach().clone() for k, v in st.disc.named_parameters()}
    stats = jax_buffer_tree(st.disc)
    st, d, _ = eng.make_discriminator_step()(st, _x())
    assert float(d) > 0
    assert tta.adam_count(st.opt_d) == 1  # the count advances
    for k, v in st.disc.named_parameters():
        assert torch.equal(v, before[k]), k
    # the running statistics still move
    after = jax_buffer_tree(st.disc)
    assert any(not np.array_equal(stats[bn]["var"], after[bn]["var"])
               for bn in stats)
    assert st.step == 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_generator_loss_falls_on_a_fixed_batch(name):
    eng, st = _real_engine(name, disc_start=1)
    g, d = eng.make_generator_step(), eng.make_discriminator_step()
    x = _x()
    noise = torch.zeros((BATCH, 4, HW // 2, HW // 2))
    vae0 = {k: v.detach().clone() for k, v in st.vae.named_parameters()}
    disc0 = {k: v.detach().clone() for k, v in st.disc.named_parameters()}
    losses = []
    for _ in range(6):
        st, loss, log = g(st, x, noise)
        st, dl, _ = d(st, x, noise)
        assert np.isfinite(float(loss)) and np.isfinite(float(dl))
        losses.append(float(log["loss/rec"]))
    assert losses[-1] < losses[0]
    assert st.step == 6 and tta.adam_count(st.opt_g) == 6
    assert all(not torch.equal(v, vae0[k])
               for k, v in st.vae.named_parameters() if k.endswith("conv_in.weight"))
    assert any(not torch.equal(v, disc0[k])
               for k, v in st.disc.named_parameters())
    for p in st.disc.parameters():
        assert p.grad is None
    for p in eng.lpips.parameters() if eng.lpips is not None else ():
        assert p.grad is None and not p.requires_grad
