"""The fused-norm configuration of the port against the JAX package, on the
CPU at tiny shapes.

Kernels (their plain versions, which the CPU runs):
  * GroupNorm+SiLU: `group_norm_silu_reference` against the JAX composite
    and against the Pallas kernel in interpret mode (`_pallas_gn_silu`),
    1e-5 * max |JAX|, a large-mean input included; and in bf16 against the
    Pallas kernel, each element within one bf16 rounding step;
  * GroupNorm+SiLU+3x3 conv: `gn_silu_conv_reference` against the JAX
    composite at the JAX test's own tolerance (atol = rtol = 2e-5) and
    against `_pallas_gn_silu_conv` in interpret mode on well-conditioned
    inputs; Cin != Cout, odd H, Cout = 4, groups < 32. On a large-mean
    input the port is held to the two-pass composite only: the Pallas
    wrapper's single-pass E[x^2] - mean^2 statistics drift there, and the
    test records by how much.
Autograd: the two Functions (the CPU forward is the plain version) against
`jax.grad` of the JAX custom-VJP functions, 1e-5.
Modules: ResBlock, ResnetBlock3D, VAEResnetBlock and ResnetBlock2D with
both switches on in both packages (NEURONS_TPU_FUSED_NORM=1,
NEURONS_TPU_FUSED_GNCONV=1), 1e-4; the JAX parameter tree is the same with
the switches on or off, so `load_jax_params` fills both configurations.
Slice: the tiny stage 3 (`reconstruct_keyframes`, enhance mode: the UNet,
VAE and DecoderVideo) with both switches on in both packages, 1e-3 with
captions equal, as tests/test_torch_port_keyframe.py holds it unfused.

Large-mean inputs are quantised to multiples of 2^-8 so that the two-pass
group sums are exact in f32 and the comparison measures the algorithm, not
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.models import decoder_video as jdv
from neurons_tpu.models import unet2d as ju2
from neurons_tpu.models import unet3d as ju3
from neurons_tpu.models import vae as jvae
from neurons_tpu.ops import fused_conv as jfc
from neurons_tpu.ops import fused_norm as jfn
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import decoder_video as tdv
from neurons_tpu_torch.models import unet2d as tu2
from neurons_tpu_torch.models import unet3d as tu3
from neurons_tpu_torch.models import vae as tvae
from neurons_tpu_torch.ops import fused_conv as tfc
from neurons_tpu_torch.ops import fused_norm as tfn
from test_torch_port_keyframe import _compare, build_slice
from torch_port_utils import randomize, rel_err, t

KEY = jax.random.PRNGKey(0)
SWITCHES = ("NEURONS_TPU_FUSED_NORM", "NEURONS_TPU_FUSED_GNCONV")


@pytest.fixture()
def fused(monkeypatch):
    for name in SWITCHES:
        monkeypatch.setenv(name, "1")


def nhwc_inputs(seed, n, h, w, c, mean=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c), dtype=np.float32)
    if mean:
        x = (np.round(x * 256) / 256 + mean).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias, rng


def nchw(x):
    return t(x).permute(0, 3, 1, 2)


def conv_params(rng, cin, cout):
    """A flax conv kernel [3, 3, Cin, Cout] and its bias."""
    k = (0.1 * rng.standard_normal((3, 3, cin, cout))).astype(np.float32)
    return k, (0.1 * rng.standard_normal(cout)).astype(np.float32)


def torch_kernel(k):
    """flax [3, 3, Cin, Cout] -> torch [Cout, Cin, 3, 3]."""
    return t(k).permute(3, 2, 0, 1)


# --- GroupNorm + SiLU -----------------------------------------------------

# (N, H, W, C, groups, mean): a large mean with an exactly summable slab
GN_CASES = [(2, 4, 4, 16, 4, 0.0), (1, 5, 7, 32, 8, 0.0),
            (2, 6, 5, 16, 4, 100.0)]


@pytest.mark.parametrize("case", GN_CASES, ids=str)
def test_gn_silu_plain_matches_jax_and_pallas(case):
    n, h, w, c, groups, mean = case
    x, scale, bias, _ = nhwc_inputs(1, n, h, w, c, mean)
    got = tfn.group_norm_silu_reference(nchw(x), t(scale), t(bias), groups,
                                        1e-5).permute(0, 2, 3, 1)
    ref = jfn.group_norm_silu_reference(x, scale, bias, groups, 1e-5)
    pallas = jfn._pallas_gn_silu(x, scale, bias, groups=groups, eps=1e-5,
                                 interpret=True)
    assert rel_err(got, ref) <= 1e-5
    assert rel_err(got, pallas) <= 1e-5


@pytest.mark.parametrize("case", GN_CASES, ids=str)
def test_gn_silu_plain_bf16_matches_pallas(case):
    # bf16 in both packages: `group_norm_silu_reference` against
    # `_pallas_gn_silu` in interpret mode. Both take two-pass f32
    # statistics of the same bf16 input and the affine and SiLU in f32,
    # then round to bf16, so an element may only land on the other side of
    # one bf16 rounding step (f32 sums in another order). Tolerance: each
    # element within one bf16 step of its own magnitude (2^(floor(log2
    # |y|) - 7)); measured: equal bits at 3 of 4 probe shapes, one step at
    # 0.01% of the elements at the fourth.
    n, h, w, c, groups, mean = case
    x, scale, bias, _ = nhwc_inputs(1, n, h, w, c, mean)
    jx, js, jb = (jnp.asarray(a, jnp.bfloat16) for a in (x, scale, bias))
    tx, ts, tb = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (jx, js, jb))
    got = tfn.group_norm_silu_reference(tx.permute(0, 3, 1, 2), ts, tb,
                                        groups, 1e-5)
    assert got.dtype == torch.bfloat16
    got = got.permute(0, 2, 3, 1).float().numpy()
    ref = np.asarray(jfn._pallas_gn_silu(jx, js, jb, groups=groups,
                                         eps=1e-5, interpret=True)
                     .astype(jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                   - 7)
    assert (np.abs(got - ref) <= step).all()


def test_gn_silu_wrapper_on_cpu_is_plain_and_counts_nothing():
    x, scale, bias, _ = nhwc_inputs(2, 2, 3, 5, 8)
    before = tfn.GN_SILU_LAUNCHES.total
    got = tfn.gn_silu_fwd(nchw(x), t(scale), t(bias), 4)
    want = tfn.group_norm_silu_reference(nchw(x), t(scale), t(bias), 4)
    assert torch.equal(got, want)
    assert tfn.GN_SILU_LAUNCHES.total == before


@pytest.mark.parametrize("bad", ["groups", "weight", "rank"])
def test_gn_silu_wrapper_rejects_bad_operands(bad):
    x, w, b = torch.zeros(2, 8, 3, 3), torch.ones(8), torch.zeros(8)
    with pytest.raises(ValueError):
        if bad == "groups":
            tfn.gn_silu_fwd(x, w, b, 3)
        elif bad == "weight":
            tfn.gn_silu_fwd(x, torch.ones(4), b, 4)
        else:
            tfn.gn_silu_fwd(torch.zeros(8), w, b, 4)


# --- GroupNorm + SiLU + 3x3 conv ------------------------------------------

# (N, H, W, Cin, Cout, groups): Cin != Cout, odd H, Cout = 4, groups < 32
CONV_CASES = [(2, 8, 8, 8, 8, 4), (1, 9, 10, 16, 8, 4), (2, 7, 5, 16, 4, 8),
              (1, 6, 6, 32, 48, 16)]


@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_gn_silu_conv_plain_matches_jax_and_pallas(case):
    n, h, w, cin, cout, groups = case
    x, scale, bias, rng = nhwc_inputs(3, n, h, w, cin)
    k, cb = conv_params(rng, cin, cout)
    got = tfc.gn_silu_conv_reference(nchw(x), t(scale), t(bias),
                                     torch_kernel(k), t(cb), groups, 1e-5)
    got = got.permute(0, 2, 3, 1).numpy()
    ref = jfc.gn_silu_conv_reference(x, scale, bias, k, cb, groups, 1e-5)
    pallas = jfc._pallas_gn_silu_conv(x, scale, bias, k, cb, groups, 1e-5,
                                      interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5,
                               rtol=2e-5)


def test_gn_silu_conv_large_mean_is_two_pass():
    # 256 elements a group: the mean is exact, the centred values too
    x, scale, bias, rng = nhwc_inputs(4, 1, 8, 8, 16, mean=64.0)
    k, cb = conv_params(rng, 16, 16)
    got = tfc.gn_silu_conv_reference(nchw(x), t(scale), t(bias),
                                     torch_kernel(k), t(cb), 4, 1e-5)
    got = got.permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jfc.gn_silu_conv_reference(x, scale, bias, k, cb, 4,
                                                1e-5))
    pallas = np.asarray(jfc._pallas_gn_silu_conv(x, scale, bias, k, cb, 4,
                                                 1e-5, interpret=True))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    port_gap = rel_err(got, ref)
    single_pass_drift = rel_err(pallas, ref)
    print(f"mean 64: port vs two-pass composite {port_gap:.3e}; the "
          f"single-pass Pallas form {single_pass_drift:.3e}")
    # the single-pass statistics are a known divergence of the JAX wrapper
    # (ROADMAP queue 3), not a behaviour the port takes on
    assert single_pass_drift > 10 * max(port_gap, 1e-7)


def test_gn_silu_conv_wrapper_on_cpu_is_plain_and_counts_nothing():
    x, scale, bias, rng = nhwc_inputs(5, 2, 5, 6, 8)
    k, cb = conv_params(rng, 8, 4)
    args = (nchw(x), t(scale), t(bias), torch_kernel(k), t(cb), 4)
    before = tfc.GN_SILU_CONV_LAUNCHES.total
    assert torch.equal(tfc.gn_silu_conv_fwd(*args),
                       tfc.gn_silu_conv_reference(*args))
    assert tfc.GN_SILU_CONV_LAUNCHES.total == before
    with pytest.raises(ValueError):
        tfc.gn_silu_conv_fwd(args[0], *args[1:3], torch.zeros(4, 8, 1, 1),
                             args[4], 4)


def test_gn_silu_conv_reference_tf32_rounds_the_operands():
    x, scale, bias, rng = nhwc_inputs(6, 1, 5, 5, 8)
    k, cb = conv_params(rng, 8, 8)
    args = (nchw(x), t(scale), t(bias), torch_kernel(k), t(cb), 4)
    plain = tfc.gn_silu_conv_reference(*args)
    tf32 = tfc.gn_silu_conv_reference_tf32(*args)
    gap = rel_err(tf32, plain.numpy())
    assert 1e-6 < gap < 2e-3  # TF32 keeps 11 significant bits


# --- autograd -------------------------------------------------------------

def test_gn_silu_function_gradients_match_jax_vjp():
    x, scale, bias, rng = nhwc_inputs(7, 2, 4, 5, 16)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfn.group_norm_silu(*a, 4, 1e-5) * dy),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    ins = [nchw(x).requires_grad_(), t(scale).requires_grad_(),
           t(bias).requires_grad_()]
    out = tfn.GroupNormSiLUFn.apply(*ins, 4, 1e-5)
    got = torch.autograd.grad(out, ins, nchw(dy))
    assert rel_err(got[0].permute(0, 2, 3, 1), want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 1e-5
    assert rel_err(got[2], want[2]) <= 1e-5


def test_gn_silu_conv_function_gradients_match_jax_vjp():
    x, scale, bias, rng = nhwc_inputs(8, 2, 6, 5, 16)
    k, cb = conv_params(rng, 16, 8)
    dy = rng.standard_normal((2, 6, 5, 8)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jfc.gn_silu_conv(*a, 4, 1e-5) * dy),
                    argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray,
                                                  (x, scale, bias, k, cb)))
    ins = [nchw(x).requires_grad_(), t(scale).requires_grad_(),
           t(bias).requires_grad_(), torch_kernel(k).requires_grad_(),
           t(cb).requires_grad_()]
    out = tfc.GNSiLUConvFn.apply(*ins, 4, 1e-5)
    got = torch.autograd.grad(out, ins, nchw(dy))
    assert rel_err(got[0].permute(0, 2, 3, 1), want[0]) <= 1e-5
    assert rel_err(got[1], want[1]) <= 1e-5
    assert rel_err(got[2], want[2]) <= 1e-5
    assert rel_err(got[3].permute(2, 3, 1, 0), want[3]) <= 1e-5
    assert rel_err(got[4], want[4]) <= 1e-5


def test_routing_reads_the_switches_per_call(monkeypatch):
    x = torch.randn(2, 8, 3, 3, requires_grad=True)
    w, b = torch.ones(8), torch.zeros(8)
    cw, cb = torch.randn(4, 8, 3, 3), torch.zeros(4)
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    assert tfn.group_norm_silu(x, w, b, 4).grad_fn.name() != \
        "GroupNormSiLUFnBackward"
    assert tfc.gn_silu_conv(x, w, b, cw, cb, 4).grad_fn.name() != \
        "GNSiLUConvFnBackward"
    monkeypatch.setenv("NEURONS_TPU_FUSED_NORM", "1")
    assert tfn.group_norm_silu(x, w, b, 4).grad_fn.name() == \
        "GroupNormSiLUFnBackward"
    monkeypatch.setenv("NEURONS_TPU_FUSED_GNCONV", "1")
    assert tfc.gn_silu_conv(x, w, b, cw, cb, 4).grad_fn.name() == \
        "GNSiLUConvFnBackward"


# --- modules --------------------------------------------------------------

def _japply(module, params, *args):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a))(params,
                                                                  *args)


def _module_pair(jmod, tmod, seed, *inputs):
    """(JAX output, port output) of the same randomised parameters; inputs
    NHWC for JAX, NCHW (2-D ones as they are) for the port."""
    params = randomize(jax.eval_shape(jmod.init, KEY, *inputs)["params"],
                       seed)
    load_jax_params(tmod.eval(), params)
    ref = _japply(jmod, params, *inputs)
    with torch.no_grad():
        got = tmod(*(nchw(a) if a.ndim == 4 else t(a) for a in inputs))
    return ref, got.permute(0, 2, 3, 1)


def _modules(cin, cout):
    """(name, JAX module, port module, inputs) of the four res blocks."""
    rng = np.random.default_rng(cin * 100 + cout)
    x = rng.standard_normal((2, 6, 5, cin), dtype=np.float32)
    emb = rng.standard_normal((2, 12), dtype=np.float32)
    return [
        ("ResBlock", ju2.ResBlock(cout, groups=4),
         tu2.ResBlock(cin, cout, 12, groups=4), (x, emb)),
        ("ResnetBlock3D", ju3.ResnetBlock3D(cout, groups=4),
         tu3.ResnetBlock3D(cin, cout, 12, groups=4), (x, emb)),
        ("VAEResnetBlock", jvae.VAEResnetBlock(cout, groups=4),
         tvae.VAEResnetBlock(cin, cout, groups=4), (x,)),
        ("ResnetBlock2D", jdv.ResnetBlock2D(cout, groups=4),
         tdv.ResnetBlock2D(cin, cout, groups=4), (x,)),
    ]


@pytest.mark.parametrize("which", range(4), ids=["ResBlock", "ResnetBlock3D",
                                                 "VAEResnetBlock",
                                                 "ResnetBlock2D"])
@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16)])
def test_res_blocks_fused_match_jax(fused, which, cin, cout):
    _, jmod, tmod, inputs = _modules(cin, cout)[which]
    ref, got = _module_pair(jmod, tmod, 60 + which, *inputs)
    assert rel_err(got, ref) <= 1e-4


def test_parameter_tree_is_the_same_with_the_switches(monkeypatch):
    for name, jmod, tmod, inputs in _modules(8, 16):
        trees = []
        for on in (False, True):
            for sw in SWITCHES:
                if on:
                    monkeypatch.setenv(sw, "1")
                else:
                    monkeypatch.delenv(sw, raising=False)
            shapes = jax.eval_shape(jmod.init, KEY, *inputs)["params"]
            trees.append(jax.tree_util.tree_map(lambda s: s.shape, shapes))
        assert trees[0] == trees[1], name


# --- the tiny stage-3 slice -------------------------------------------------

def test_stage3_slice_fused_matches_jax(fused):
    # traces made with the switches off must not stand in for the fused
    # JAX modules (the switches are read while tracing)
    jax.clear_caches()
    cfg, run_jax, run_port, _, _, _, _ = build_slice(38)
    ref = run_jax(True, None)
    got = run_port(True, None)
    _compare(ref, got)
    np.testing.assert_array_equal(got.cls_logits.argmax(-1).numpy(),
                                  np.asarray(ref.cls_logits).argmax(-1))
