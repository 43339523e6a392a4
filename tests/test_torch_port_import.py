"""The port's importers, converters and exporters against the JAX
package's, on the CPU.

Every importer and converter of `neurons_tpu_torch/interop/torch_import.py`
and `convert_ldm.py` that stages 1-3 and 5 call runs beside its JAX twin on
the same synthetic state dict in the reference layout (the key-exact torch
replicas of tests/test_importers_structural.py and the ensemble builder of
tests/test_ensemble_import.py): the trees must be equal leaf for leaf
(`np.array_equal`) and the unused-key lists equal. Then each exporter of
`torch_export.py` (the writers chip_smoke.py uses for the reference files)
is round-tripped: a port module's tree -> state dict -> the importer gives
the tree back exactly, with no unused key, and the state dict holds the
same keys as the replica of the reference layout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from neurons_tpu import config as jcfg
from neurons_tpu.interop import convert_ldm as jconv
from neurons_tpu.interop import torch_import as jti
from neurons_tpu.models.gpt2 import tiny_gpt2_config
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.interop import convert_ldm as tconv
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop import torch_import as tti
from neurons_tpu_torch.interop.from_jax import load_jax_params
from test_ensemble_import import BCFG, DCFG, PCFG, _build_reference_sd
from test_importers_structural import (TINY_3D, TINY_UNET, TINY_VAE,
                                       TDiffusersUNet3D, TLDMUNet, TLDMVAE,
                                       TSparseControlNet)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cls, jax_cfg):
    return cls(**{f.name: getattr(jax_cfg, f.name)
                  for f in dataclasses.fields(cls)})


def assert_equal_trees(a, b, path=""):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (path, sorted(set(a) ^ set(b)))
        for k in a:
            assert_equal_trees(a[k], b[k], f"{path}/{k}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.shape == y.shape and x.dtype == y.dtype, (path, x.shape,
                                                           y.shape)
        assert np.array_equal(x, y), path


def same_import(jfn, tfn, sd, *args, **kw):
    """Both importers on one state dict: equal trees and unused lists.
    Returns the port's."""
    jp, ju = jfn(dict(sd), *args, **kw)
    tp, tu = tfn(dict(sd), *args, **kw)
    assert_equal_trees(tp, jp)
    assert tu == ju
    return tp, tu


def seeded(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=g))
    return module


EXTRA = {"not.a.weight": torch.zeros(2)}  # an unused key, reported


SD15 = jcfg.UNet2DConfig(model_channels=8, channel_mult=(1, 2),
                         num_res_blocks=1, attention_resolutions=(1,),
                         transformer_depth=(1, 1), num_head_channels=4,
                         context_dim=12)
SD15_3D = jcfg.UNet3DConfig(block_out_channels=(8, 16), layers_per_block=1,
                            down_block_types=("CrossAttnDownBlock3D",
                                              "DownBlock3D"),
                            up_block_types=("UpBlock3D",
                                            "CrossAttnUpBlock3D"),
                            cross_attention_dim=12, attention_head_dim=4,
                            norm_num_groups=8, use_motion_module=False)


# --- importers against their JAX twins ---------------------------------------

def test_ldm_unet():
    sd = {**seeded(TLDMUNet(TINY_UNET), 1).state_dict(), **EXTRA}
    _, unused = same_import(jti.import_ldm_unet, tti.import_ldm_unet, sd,
                            TINY_UNET)
    assert unused == ["not.a.weight"]


def test_ldm_vae_both_routes():
    sd = seeded(TLDMVAE(TINY_VAE), 2).state_dict()
    same_import(jti.import_ldm_vae, tti.import_ldm_vae, sd, TINY_VAE)
    jd, td = (jconv.convert_ldm_vae_to_diffusers(dict(sd)),
              tconv.convert_ldm_vae_to_diffusers(dict(sd)))
    assert sorted(jd) == sorted(td)
    assert all(np.array_equal(tti.t2j(jd[k]), tti.t2j(td[k])) for k in jd)
    same_import(jti.import_diffusers_vae, tti.import_diffusers_vae, td,
                num_blocks=2, layers_per_block=1)


def test_sd15_unet_conversion():
    sd = seeded(TLDMUNet(SD15, linear_proj=False, fixed_heads=4,
                         with_label=False), 3).state_dict()
    jd = jconv.convert_ldm_unet_to_diffusers(dict(sd))
    td = tconv.convert_ldm_unet_to_diffusers(dict(sd))
    assert sorted(jd) == sorted(td)
    assert all(torch.equal(jd[k], td[k]) for k in jd)
    same_import(jti.import_animatediff_unet3d, tti.import_animatediff_unet3d,
                td, SD15_3D)


def test_animatediff_unet3d_and_motion_modules():
    sd = {**seeded(TDiffusersUNet3D(TINY_3D), 4).state_dict(), **EXTRA}
    spatial = {k: v for k, v in sd.items() if "motion_modules." not in k}
    tp, tu = same_import(jti.import_animatediff_unet3d,
                         tti.import_animatediff_unet3d, spatial, TINY_3D)
    assert tu == ["not.a.weight"]
    jmm, tmm = jti.filter_motion_module(sd), tti.filter_motion_module(sd)
    assert sorted(jmm) == sorted(tmm)
    jp, ju = jti.import_motion_modules(tmm, TINY_3D, dict(tp))
    tp2, tu2 = tti.import_motion_modules(tmm, TINY_3D, dict(tp))
    assert_equal_trees(tp2, jp)
    assert tu2 == ju == []


def test_sparse_controlnet():
    sd = {**seeded(TSparseControlNet(TINY_3D), 5).state_dict(), **EXTRA}
    _, unused = same_import(jti.import_sparse_controlnet,
                            tti.import_sparse_controlnet, sd, TINY_3D)
    assert unused == ["not.a.weight"]


def test_neurons_ensemble_core_and_warm_starts():
    torch.manual_seed(6)
    sd = _build_reference_sd()
    kw = dict(n_blocks=BCFG.n_blocks, prior_depth=PCFG.depth,
              gpt2_layers=tiny_gpt2_config().n_layer, decoder_up_blocks=3,
              decoder_layers_per_block=1)
    _, unused = same_import(jti.import_neurons_ensemble,
                            tti.import_neurons_ensemble, sd, **kw)
    assert unused == []
    same_import(jti.import_neurons_core, tti.import_neurons_core, sd,
                n_blocks=BCFG.n_blocks)
    same_import(jti.import_mindeye_backbone, tti.import_mindeye_backbone,
                sd, n_blocks=BCFG.n_blocks)
    same_import(jti.import_coco_clipproj, tti.import_coco_clipproj,
                {"proj": sd["clipproj.proj"]})
    gpt2 = {k[len("text_dec.decoder."):]: v for k, v in sd.items()
            if k.startswith("text_dec.decoder.")}
    same_import(jti.import_gpt2, tti.import_gpt2, gpt2,
                tiny_gpt2_config().n_layer)


def test_ldm_apply_ema_count():
    g = torch.Generator().manual_seed(7)
    sd = {f"model.diffusion_model.b{i}.w": torch.randn(3, generator=g)
          for i in range(5)}
    sd["first_stage_model.x.weight"] = torch.randn(2, generator=g)
    sd.update({f"model_ema.diffusion_modelb{i}w": torch.randn(
        3, generator=g) for i in range(3)})
    sd["model_ema.num_updates"] = torch.tensor(10)
    sd["model_ema.decay"] = torch.tensor(0.99)
    jo, jn = jti.ldm_apply_ema(sd)
    to, tn = tti.ldm_apply_ema(sd)
    assert tn == jn == 3
    assert sorted(to) == sorted(jo)
    assert all(torch.equal(to[k], jo[k]) for k in jo)
    assert torch.equal(to["model.diffusion_model.b1.w"],
                       sd["model_ema.diffusion_modelb1w"])
    assert tti.strip_prefix(sd, "first_stage_model.").keys() == \
        jti.strip_prefix(sd, "first_stage_model.").keys()


def test_lora_merge_at_alpha_08():
    rs = np.random.RandomState(8)
    key = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    conv_key = "down_blocks.0.resnets.0.conv1.weight"
    target = {key: rs.randn(6, 5).astype(np.float32),
              conv_key: rs.randn(6, 5, 1, 1).astype(np.float32),
              "conv_in.weight": rs.randn(4, 4).astype(np.float32)}
    lora = tex.lora_state_dict([key], {key: (6, 5)}, rank=2, seed=9,
                               scale=1.0)
    lora["lora_unet_down_blocks_0_resnets_0_conv1.lora_down.weight"] = \
        rs.randn(2, 5, 1, 1).astype(np.float32)
    lora["lora_unet_down_blocks_0_resnets_0_conv1.lora_up.weight"] = \
        rs.randn(6, 2, 1, 1).astype(np.float32)
    lora["lora_unet_no_such_module.lora_down.weight"] = np.zeros((2, 5))
    lora["lora_unet_no_such_module.lora_up.weight"] = np.zeros((6, 2))
    jm, jmiss = jconv.merge_lora_into_state_dict(target, lora, alpha=0.8)
    tm, tmiss = tconv.merge_lora_into_state_dict(target, lora, alpha=0.8)
    assert tmiss == jmiss == ["lora_unet_no_such_module.lora_down.weight"]
    assert sorted(tm) == sorted(jm)
    assert all(np.array_equal(tti.t2j(tm[k]), tti.t2j(jm[k])) for k in jm)
    stem = "lora_unet_" + key[:-len(".weight")].replace(".", "_")
    want = target[key] + 0.8 * (lora[f"{stem}.lora_up.weight"]
                                @ lora[f"{stem}.lora_down.weight"])
    assert np.allclose(tm[key], want, rtol=1e-6)
    up, down = rs.randn(6, 2), rs.randn(2, 5)
    assert np.array_equal(tti.merge_lora(target[key], up, down, 0.8),
                          jti.merge_lora(target[key], up, down, 0.8))


# --- the exporters, round-tripped --------------------------------------------

def _round_trip(module, writer, importer, ref_keys=None, w_args=(),
                i_args=()):
    tree = tex.jax_tree(module)
    sd = writer(tree, *w_args)
    if ref_keys is not None:
        assert sorted(sd) == sorted(ref_keys)
    got, unused = importer(tex.to_torch(sd), *i_args)
    assert unused == []
    assert_equal_trees(got, tree)
    load_jax_params(module, got)  # and the tree fills the module strictly
    return sd


def test_jax_tree_inverts_load_jax_params():
    from neurons_tpu_torch.models.unet2d import UNetModel
    m = seeded(UNetModel(port_cfg(tcfg.UNet2DConfig, TINY_UNET),
                         device="cpu"), 10)
    m2 = UNetModel(port_cfg(tcfg.UNet2DConfig, TINY_UNET), device="cpu")
    load_jax_params(m2, tex.jax_tree(m))
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                  m2.parameters()))


def test_export_ldm_unet():
    from neurons_tpu_torch.models.unet2d import UNetModel
    m = seeded(UNetModel(port_cfg(tcfg.UNet2DConfig, TINY_UNET),
                         device="cpu"), 11)
    _round_trip(m, tex.ldm_unet_state_dict, tti.import_ldm_unet,
                TLDMUNet(TINY_UNET).state_dict(), (TINY_UNET,), (TINY_UNET,))


def test_export_ldm_vae_both_routes():
    from neurons_tpu_torch.models.vae import AutoencoderKL
    m = seeded(AutoencoderKL(port_cfg(tcfg.VAEConfig, TINY_VAE),
                             device="cpu"), 12)
    ref = TLDMVAE(TINY_VAE).state_dict()
    _round_trip(m, tex.ldm_vae_state_dict, tti.import_ldm_vae, ref,
                (TINY_VAE,), (TINY_VAE,))
    sd = tex.to_torch(tex.ldm_vae_state_dict(tex.jax_tree(m), TINY_VAE))
    got, unused = tti.import_diffusers_vae(
        tconv.convert_ldm_vae_to_diffusers(sd), num_blocks=2,
        layers_per_block=1)
    assert unused == []
    assert_equal_trees(got, tex.jax_tree(m))


def test_export_unet3d_base_and_motion_modules():
    from neurons_tpu_torch.models.unet3d import UNet3DModel
    cfg = port_cfg(tcfg.UNet3DConfig, TINY_3D)
    m = seeded(UNet3DModel(cfg, n_frames=4, device="cpu"), 13)
    tree = tex.jax_tree(m)
    base = tex.to_torch(tex.ldm_unet3d_state_dict(tree, TINY_3D))
    mm = tex.to_torch(tex.motion_module_state_dict(tree, TINY_3D))
    ref = TDiffusersUNet3D(TINY_3D).state_dict()
    conv = tconv.convert_ldm_unet_to_diffusers(dict(base))
    assert sorted(conv) == sorted(k for k in ref
                                  if "motion_modules." not in k)
    assert sorted(tti.filter_motion_module(mm)) == sorted(
        tti.filter_motion_module(ref))
    assert any("pos_encoder.pe" in k for k in mm)
    got, unused = tti.import_animatediff_unet3d(conv, TINY_3D)
    assert unused == []
    got, unused = tti.import_motion_modules(tti.filter_motion_module(mm),
                                            TINY_3D, got)
    assert unused == []
    assert_equal_trees(got, tree)


def test_export_sparse_controlnet():
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    m = seeded(SparseControlNetModel(port_cfg(tcfg.UNet3DConfig, TINY_3D),
                                     n_frames=4, device="cpu"), 14)
    _round_trip(m, tex.sparse_controlnet_state_dict,
                tti.import_sparse_controlnet,
                TSparseControlNet(TINY_3D).state_dict(), (TINY_3D,),
                (TINY_3D,))


def test_export_clip_text():
    from neurons_tpu_torch.models.clip import CLIPTextConfig, CLIPTextTower
    cfg = CLIPTextConfig.tiny()
    m = seeded(CLIPTextTower(cfg, device="cpu"), 15)
    _round_trip(m, tex.hf_clip_text_state_dict, tti.import_hf_clip_text,
                None, (cfg.layers,), (cfg.layers,))


def test_export_neurons_ensemble_and_core():
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config as tg
    bcfg = port_cfg(tcfg.BrainModelConfig, BCFG)
    m = seeded(NeuronsDecoupler(bcfg, port_cfg(tcfg.PriorConfig, PCFG),
                                port_cfg(tcfg.DecouplerConfig, DCFG), tg(),
                                device="cpu"), 16)
    kw = dict(n_blocks=BCFG.n_blocks, prior_depth=PCFG.depth,
              gpt2_layers=tg().n_layer)
    torch.manual_seed(6)
    ref = _build_reference_sd()
    sd = _round_trip(m, lambda t: tex.neurons_ensemble_state_dict(t, **kw),
                     lambda s: tti.import_neurons_ensemble(s, **kw))
    # GPT-2's causal-mask buffers are written too (the importer drops them)
    assert sorted(k for k in sd if not k.endswith(".attn.bias")) == sorted(
        ref)
    core = tex.neurons_core_state_dict(tex.jax_tree(m.core), BCFG.n_blocks)
    got, unused = tti.import_neurons_core(tex.to_torch(core),
                                          BCFG.n_blocks)
    assert unused == []
    assert_equal_trees(got, tex.jax_tree(m.core))
