"""The port's weight loaders (`neurons_tpu_torch/interop/load_weights.py`)
against the JAX package's, on files written to a temporary directory.

Files in the reference layouts, written from seeded port modules by the
exporters (`interop/torch_export.py`, held to the importers in
tests/test_torch_port_import.py): the unclip6 Lightning checkpoint (live
UNet weights, their EMA shadows and the first-stage VAE), the SD-1.5 base
as `.safetensors` in fp16 (LDM UNet, VAE and `cond_stage_model.
transformer`), the AnimateDiff motion module, a domain-adapter LoRA and
SparseCtrl. Each port loader must return the JAX loader's tree leaf for
leaf (`np.array_equal`) and its report; the port module filled from it must
give the JAX module's forward on the JAX loader's params within 1e-5 of
max |JAX| in f32. The port's safetensors reader is held to the
`safetensors` package (F32, F16, BF16, I64) both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.interop import load_weights as jlw
from neurons_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from neurons_tpu.models.clip import CLIPTextTower as JCLIP
from neurons_tpu.models.sparse_controlnet import SparseControlNetModel as JCN
from neurons_tpu.models.unet2d import UNetModel as JUNet
from neurons_tpu.models.unet3d import UNet3DModel as JUNet3D
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu.utils.checkpoint import restore_into
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.interop import load_weights as tlw
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models.clip import CLIPTextConfig, CLIPTextTower
from neurons_tpu_torch.models.sparse_controlnet import SparseControlNetModel
from neurons_tpu_torch.models.unet2d import UNetModel
from neurons_tpu_torch.models.unet3d import UNet3DModel
from neurons_tpu_torch.models.vae import AutoencoderKL
from test_importers_structural import TINY_3D, TINY_UNET, TINY_VAE
from test_torch_port_import import assert_equal_trees, port_cfg, seeded
from torch_port_utils import rel_err, t

TOL = 1e-5
F = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_jax_branches(monkeypatch):
    monkeypatch.delenv("NEURONS_TPU_FUSED_GNCONV", raising=False)


def japply(module, params, *args, method=None):
    return jax.jit(lambda p, *a: module.apply({"params": p}, *a,
                                              method=method))(params, *args)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def filled(build, params):
    m = build()
    load_jax_params(m, params)
    return m.eval()


# --- the safetensors reader ----------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(1)
    tensors = {"a.weight": torch.randn((3, 5), generator=g).to(dtype),
               "b": torch.randn((7,), generator=g).to(dtype),
               "scalar": torch.randn((), generator=g).to(dtype),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = str(tmp_path / "x.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = tlw.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    mine = str(tmp_path / "y.safetensors")
    tex.write_safetensors(mine, tensors, {"format": "pt"})
    back = load_file(mine)
    assert all(back[k].dtype == v.dtype and torch.equal(back[k], v)
               for k, v in tensors.items())


# --- the bundles -----------------------------------------------------------------

@pytest.fixture(scope="module")
def unclip_file(tmp_path_factory):
    """unclip6-style Lightning checkpoint: live UNet weights (other
    values), their EMA shadows (the weights meant) and the VAE."""
    ucfg = port_cfg(tcfg.UNet2DConfig, TINY_UNET)
    vcfg = port_cfg(tcfg.VAEConfig, TINY_VAE)
    unet = seeded(UNetModel(ucfg, device="cpu"), 21)
    live = seeded(UNetModel(ucfg, device="cpu"), 22)
    vae = seeded(AutoencoderKL(vcfg, device="cpu"), 23)
    sd = {"model.diffusion_model." + k: v for k, v in
          tex.ldm_unet_state_dict(tex.jax_tree(live), TINY_UNET).items()}
    ema = tex.ema_state_dict({"model.diffusion_model." + k: v for k, v in
                              tex.ldm_unet_state_dict(tex.jax_tree(unet),
                                                      TINY_UNET).items()})
    sd.update(ema)
    sd.update({"first_stage_model." + k: v for k, v in
               tex.ldm_vae_state_dict(tex.jax_tree(vae), TINY_VAE).items()})
    path = tmp_path_factory.mktemp("w") / "unclip6_epoch0_step110000.ckpt"
    torch.save({"state_dict": tex.to_torch(sd), "epoch": 0}, path)
    return str(path), unet, vae


def test_unclip_engine(unclip_file):
    path, unet, vae = unclip_file
    jup, jvp, jrep = jlw.load_unclip_engine(path, TINY_UNET, TINY_VAE)
    tup, tvp, trep = tlw.load_unclip_engine(path, TINY_UNET, TINY_VAE)
    assert_equal_trees(tup, jup)
    assert_equal_trees(tvp, jvp)
    assert trep == jrep
    n_live = len(tex.ldm_unet_state_dict(tex.jax_tree(unet), TINY_UNET))
    assert trep["ema_swapped"] == n_live
    # the EMA weights are the ones loaded
    assert_equal_trees(tup, tex.jax_tree(unet))

    port = filled(lambda: UNetModel(port_cfg(tcfg.UNet2DConfig, TINY_UNET),
                                    device="cpu"), tup)
    x, ts = rand(24, 2, 4, 8, 8), np.array([3.0, 17.0], np.float32)
    ctx, y = rand(25, 2, 5, 12), rand(26, 2, 6)
    ref = japply(JUNet(TINY_UNET), jup, jnp.asarray(x), jnp.asarray(ts),
                 jnp.asarray(ctx), jnp.asarray(y))
    with torch.no_grad():
        got = port(t(x), t(ts), t(ctx), t(y))
    assert rel_err(got, ref) <= TOL

    pvae = filled(lambda: AutoencoderKL(port_cfg(tcfg.VAEConfig, TINY_VAE),
                                        device="cpu"), tvp)
    z = rand(27, 2, 3, 4, 4)
    ref = japply(JVAE(TINY_VAE), jvp, jnp.asarray(z), method=JVAE.decode)
    with torch.no_grad():
        got = pvae.decode(t(z))
    assert rel_err(got, ref) <= TOL


@pytest.fixture(scope="module")
def stage5_files(tmp_path_factory):
    """The stage-5 bundle in the reference's files: the SD-1.5 base as fp16
    safetensors (LDM UNet, VAE, text encoder), the motion module, a LoRA
    and SparseCtrl."""
    d = tmp_path_factory.mktemp("w5")
    u3 = port_cfg(tcfg.UNet3DConfig, TINY_3D)
    unet = seeded(UNet3DModel(u3, n_frames=F, device="cpu"), 31)
    cn = seeded(SparseControlNetModel(u3, n_frames=F, device="cpu"), 32)
    vcfg = port_cfg(tcfg.VAEConfig, TINY_VAE)
    vae = seeded(AutoencoderKL(vcfg, device="cpu"), 33)
    ccfg = CLIPTextConfig.tiny()
    text = seeded(CLIPTextTower(ccfg, device="cpu"), 34)
    tree = tex.jax_tree(unet)
    base = {"model.diffusion_model." + k: v for k, v in
            tex.ldm_unet3d_state_dict(tree, TINY_3D).items()}
    base.update({"first_stage_model." + k: v for k, v in
                 tex.ldm_vae_state_dict(tex.jax_tree(vae), TINY_VAE).items()})
    text_tree = {k: v for k, v in tex.jax_tree(text).items()
                 if k != "text_projection"}  # SD's encoder has none
    base.update({"cond_stage_model.transformer." + k: v for k, v in
                 tex.hf_clip_text_state_dict(text_tree,
                                             ccfg.layers).items()})
    paths = {"base": str(d / "realisticVisionV60B1_v51VAE.safetensors"),
             "mm": str(d / "v3_sd15_mm.ckpt"),
             "lora": str(d / "v3_sd15_adapter.ckpt"),
             "cn": str(d / "v3_sd15_sparsectrl_rgb.ckpt")}
    tex.write_safetensors(paths["base"], tex.to_torch(base, torch.float16))
    torch.save(tex.to_torch(tex.motion_module_state_dict(tree, TINY_3D),
                            torch.float16), paths["mm"])
    keys = ["down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q."
            "weight", "up_blocks.1.attentions.0.transformer_blocks.0.attn2."
            "to_out.0.weight"]
    shapes = {k: (8, 8) for k in keys}  # level 0's width on both sides
    torch.save(tex.to_torch(tex.lora_state_dict(keys, shapes, 2, 35, 0.1)),
               paths["lora"])
    torch.save({"state_dict": tex.to_torch(
        tex.sparse_controlnet_state_dict(tex.jax_tree(cn), TINY_3D),
        torch.float16)}, paths["cn"])
    return paths, ccfg


def test_animatediff_unet3d(stage5_files):
    paths, _ = stage5_files
    args = (paths["base"], paths["mm"], TINY_3D)
    jp, jrep = jlw.load_animatediff_unet3d(*args, lora_path=paths["lora"])
    tp, trep = tlw.load_animatediff_unet3d(*args, lora_path=paths["lora"])
    assert_equal_trees(tp, jp)
    assert trep == jrep
    assert trep["lora_unmatched"] == [] and trep["motion_unused"] == []
    # the LoRA moved the weights it names (alpha 0.8)
    assert not np.array_equal(
        tp["down_0_attn_0"]["block_0_attn1"]["to_q"]["kernel"],
        tlw.TI.import_animatediff_unet3d(tlw.convert_ldm.
            convert_ldm_unet_to_diffusers(tlw.TI.strip_prefix(
                tlw.read_safetensors(paths["base"]),
                "model.diffusion_model.")), TINY_3D)[0]
        ["down_0_attn_0"]["block_0_attn1"]["to_q"]["kernel"])
    port = filled(lambda: UNet3DModel(port_cfg(tcfg.UNet3DConfig, TINY_3D),
                                      n_frames=F, device="cpu"), tp)
    x = rand(36, 2, 4, F, 8, 8)
    ts = np.array([3.0, 11.0], np.float32)
    ctx = rand(37, 2, 5, 12)
    ref = japply(JUNet3D(TINY_3D, n_frames=F), jp, jnp.asarray(x),
                 jnp.asarray(ts), jnp.asarray(ctx))
    with torch.no_grad():
        got = port(t(x), t(ts), t(ctx), None, None)
    assert rel_err(got, ref) <= TOL


def test_sparse_controlnet(stage5_files):
    paths, _ = stage5_files
    jp, jrep = jlw.load_sparse_controlnet(paths["cn"], TINY_3D)
    tp, trep = tlw.load_sparse_controlnet(paths["cn"], TINY_3D)
    assert_equal_trees(tp, jp)
    assert trep == jrep
    port = filled(lambda: SparseControlNetModel(
        port_cfg(tcfg.UNet3DConfig, TINY_3D), n_frames=F, device="cpu"), tp)
    rng = np.random.default_rng(38)
    x = rng.standard_normal((2, 4, F, 8, 8), dtype=np.float32)
    ts = np.array([5.0, 9.0], np.float32)
    ctx = rng.standard_normal((2, 5, 12), dtype=np.float32)
    cond = rng.standard_normal((2, 4, F, 8, 8), dtype=np.float32)
    mask = (rng.uniform(size=(2, 1, F, 8, 8)) > 0.5).astype(np.float32)
    ref_down, ref_mid = japply(JCN(TINY_3D, n_frames=F), jp, x, ts, ctx,
                               cond, mask, jnp.float32(0.7))
    with torch.no_grad():
        down, mid = port(t(x), t(ts), t(ctx), t(cond), t(mask), 0.7)
    for got, ref in zip(down, ref_down):
        assert rel_err(got.permute(0, 2, 3, 1), ref) <= TOL
    assert rel_err(mid.permute(0, 2, 3, 1), ref_mid) <= TOL


def test_sd_vae_and_text_encoder(stage5_files):
    paths, ccfg = stage5_files
    jp, jrep = jlw.load_sd_vae(paths["base"], TINY_VAE)
    tp, trep = tlw.load_sd_vae(paths["base"], TINY_VAE)
    assert_equal_trees(tp, jp)
    assert trep == jrep
    pvae = filled(lambda: AutoencoderKL(port_cfg(tcfg.VAEConfig, TINY_VAE),
                                        device="cpu"), tp)
    x = np.random.default_rng(39).uniform(
        -1, 1, (2, 3, 16, 16)).astype(np.float32)
    ref = japply(JVAE(TINY_VAE), jp, jnp.asarray(x), method=JVAE.encode)
    with torch.no_grad():
        got = pvae.encode(t(x))
    assert rel_err(got.mean, ref.mean) <= TOL

    jt, jtr = jlw.load_sd_text_encoder(paths["base"], ccfg.layers)
    tt, ttr = tlw.load_sd_text_encoder(paths["base"], ccfg.layers)
    assert_equal_trees(tt, jt)
    assert ttr == jtr
    jcc = JCLIPConfig(*ccfg)
    jtower = JCLIP(jcc)
    init = jax.tree_util.tree_map(np.asarray, jtower.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"])
    jparams = restore_into(init, jt)
    port = CLIPTextTower(ccfg, device="cpu").eval()
    load_jax_params(port, jparams)
    toks = np.random.default_rng(40).integers(
        0, ccfg.vocab_size, (2, ccfg.context_length), dtype=np.int32)
    ref_x, _ = japply(jtower, jparams, toks)
    with torch.no_grad():
        got_x, _ = port(torch.from_numpy(toks).long())
    assert rel_err(got_x, ref_x) <= TOL


def test_fp16_file_to_bf16_module(stage5_files):
    """The fp16 files come out of `t2j` in f32; the stage casts to bf16:
    each parameter of a module materialised in bf16 and filled is its
    f32 value rounded once to bf16 (what the JAX CLI's `_cast_host_tree`
    gives)."""
    paths, _ = stage5_files
    tp, _ = tlw.load_sparse_controlnet(paths["cn"], TINY_3D)
    build = lambda **kw: SparseControlNetModel(  # noqa: E731
        port_cfg(tcfg.UNet3DConfig, TINY_3D), n_frames=F, **kw)
    m = tlw.materialize(build, "cpu", torch.bfloat16)
    load_jax_params(m, tp)
    f32 = filled(lambda: build(device="cpu"), tp)
    for (n, p), q in zip(m.named_parameters(), f32.parameters()):
        assert p.dtype == torch.bfloat16
        assert torch.equal(p, q.to(torch.bfloat16)), n
    # the fp16 values survived the f32 upcast exactly
    raw = torch.load(paths["cn"])["state_dict"]["conv_in.weight"]
    assert torch.equal(f32.conv_in.weight, raw.float())


def test_materialize_recomputes_buffers():
    u3 = port_cfg(tcfg.UNet3DConfig, TINY_3D)
    m = tlw.materialize(lambda **kw: UNet3DModel(u3, n_frames=F, **kw),
                        "cpu", torch.float32)
    ref = UNet3DModel(u3, n_frames=F, device="cpu")
    got = dict(m.named_buffers())
    for n, b in ref.named_buffers():
        assert torch.equal(got[n], b), n
