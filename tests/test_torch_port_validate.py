"""The port's `validate` against the JAX package's, on the CPU, and the
port's parser against the JAX CLI's.

- `cli validate --tiny --synthetic --platform cpu` writes the report that
  tests/test_cli_validate.py checks of the JAX command: random-proxy
  sources, every preset of the JAX CLI, each stage's rms_rel and corr
  finite, corr in [-1, 1] and fast != exact.
- The scoring (`pipelines/validate.py:score_presets`) of the "max" preset
  on the JAX command's tiny modules (the UNet3D and SparseCtrl cut to one
  level; every leaf drawn from numpy, carried over) and its draws (rebuilt from its keys: PRNGKey(1) tokens,
  PRNGKey(5) the unCLIP sampler's four splits, PRNGKey(2) the video
  noise, PRNGKey(3)/(4)/(5) the blurry video, keyframe and text) gives
  the JAX command's rms_rel and corr within 1e-4, stage by stage; the
  JAX side runs the command's own calls (`unclip_sample` with the
  identity decode and a zero vector, `reconstruct_video` with the pooling
  encoder).
- Every subcommand of the JAX CLI exists in the port's, with every flag.
"""

import argparse
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import cli as jcli
from neurons_tpu import config as jcfg
from neurons_tpu.models.sparse_controlnet import SparseControlNetModel as JCN
from neurons_tpu.models.unet2d import UNetModel as JUNet
from neurons_tpu.models.unet3d import UNet3DModel as JUNet3D
from neurons_tpu.pipelines.keyframe import unclip_sample as junclip
from neurons_tpu.pipelines.video import reconstruct_video as jvideo
from neurons_tpu_torch import cli as tcli
from neurons_tpu_torch import config as tcfg
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models.sparse_controlnet import SparseControlNetModel
from neurons_tpu_torch.models.unet2d import UNetModel
from neurons_tpu_torch.models.unet3d import UNet3DModel
from neurons_tpu_torch.pipelines import validate as V
from neurons_tpu_torch.pipelines.keyframe import UnclipNoise
from test_torch_port_keyframe import port_cfg
from torch_port_utils import randomize, t


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_validate_tiny_writes_the_scored_report(tmp_path):
    wdir = str(tmp_path / "weights")
    tcli.main(["validate", "--tiny", "--synthetic", "--platform", "cpu",
               "--weights_dir", wdir])
    with open(os.path.join(wdir, "fastpath_validation.json")) as f:
        rep = json.load(f)
    assert rep["weights_stage3"] == "random-proxy"
    assert rep["weights_stage5"] == "random-proxy"
    assert rep["shapes"] == {"stage3": [16, 4], "stage5": [8, 4, 3]}
    assert set(rep["presets"]) == set(jcli.FAST_PRESETS)
    for name, scores in rep["presets"].items():
        for stage in ("stage3", "stage5"):
            rms, corr = scores[stage]["rms_rel"], scores[stage]["corr"]
            # fast != exact (corr < 1 covers a deviation rounded to 0.0)
            assert rms >= 0.0 and (rms > 0.0 or corr < 1.0), (name, stage)
            assert rms < 2.0, (name, stage, rms)
            assert not math.isnan(corr), (name, stage)
            assert -1.0 <= corr <= 1.0, (name, stage, corr)


def test_validate_without_weights_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="unclip6"):
        tcli.main(["validate", "--platform", "cpu", "--weights_dir",
                   str(tmp_path)])


# --- the scoring against the JAX command's --------------------------------------

HW3, STEPS3, HW5, FRAMES, STEPS5, N_TOK = 16, 4, 8, 4, 3, 8


def _jax_configs():
    """The JAX command's tiny configs (neurons_tpu/cli.py:cmd_validate)."""
    ucfg = jcfg.UNet2DConfig(model_channels=16, channel_mult=(1, 2),
                             num_res_blocks=1, attention_resolutions=(2,),
                             transformer_depth=(1, 1), num_head_channels=8,
                             context_dim=16, adm_in_channels=8)
    u3 = jcfg.UNet3DConfig(block_out_channels=(16, 32),
                           down_block_types=("CrossAttnDownBlock3D",
                                             "DownBlock3D"),
                           up_block_types=("UpBlock3D",
                                           "CrossAttnUpBlock3D"),
                           layers_per_block=1, cross_attention_dim=16,
                           attention_head_dim=8, norm_num_groups=8,
                           motion_num_attention_heads=2)
    return ucfg, u3


def test_port_tiny_configs_are_the_jax_commands():
    ucfg, u3 = _jax_configs()
    args = argparse.Namespace(tiny=True)
    got = tcli._validate_configs(args)
    assert got[0] == port_cfg(tcfg.UNet2DConfig, ucfg)
    assert got[1] == port_cfg(tcfg.UNet3DConfig, u3)
    assert got[2:] == (HW3, STEPS3, HW5, FRAMES, STEPS5, N_TOK)


def _jax_scores(ucfg, u3, p2, p3, pc, opts3, opts5):
    """The JAX command's score3 / score5 of one preset, jitted."""
    unet2d, unet3d = JUNet(ucfg), JUNet3D(u3, n_frames=FRAMES)
    cn = JCN(u3, n_frames=FRAMES)
    tokens = jax.random.normal(jax.random.PRNGKey(1),
                               (1, N_TOK, ucfg.context_dim)) * 0.3
    vec = jnp.zeros((1, ucfg.adm_in_channels))

    def unet2d_apply(p, x, tt, ctx, v, **kw):
        return unet2d.apply({"params": p}, x, tt, ctx, v, **kw)

    def stage3(opts):
        return jax.jit(lambda p: junclip(
            unet2d_apply, p, lambda z: z, jax.random.PRNGKey(5), tokens,
            vec, num_steps=STEPS3, latent_hw=HW3, **opts))(p2)

    def pool_encode(x):
        n, c, h, w = x.shape
        q = x.reshape(n, c, h // 8, 8, w // 8, 8).mean(axis=(3, 5))
        return jnp.concatenate([q, q[:, :1]], axis=1) - 0.5

    px = HW5 * 8

    def stage5(opts):
        def run(up, cp):
            return jvideo(
                unet3d_apply=lambda p, x, tt, c, d, m, **k:
                    unet3d.apply(p, x, tt, c, d, m, **k),
                unet3d_params={"params": up},
                controlnet_apply=lambda p, x, tt, c, cond, mask, s:
                    cn.apply(p, x, tt, c, cond, mask, s),
                controlnet_params={"params": cp},
                vae_encode_mode=pool_encode,
                vae_decode=lambda z: jnp.zeros((z.shape[0], 3, px, px)),
                key=jax.random.PRNGKey(2),
                blurry_video=jax.random.uniform(jax.random.PRNGKey(3),
                                                (1, 6, 3, px, px)),
                keyframe=jax.random.uniform(jax.random.PRNGKey(4),
                                            (1, 3, px, px)),
                text_embeddings=jax.random.normal(
                    jax.random.PRNGKey(5),
                    (1, 77, u3.cross_attention_dim)) * 0.1,
                uncond_embeddings=jnp.zeros((1, 77, u3.cross_attention_dim)),
                num_steps=STEPS5, n_frames=FRAMES, **opts).latents
        return jax.jit(run)(p3, pc)

    out = {}
    for stage, run, opts in (("stage3", stage3, opts3),
                             ("stage5", stage5, opts5)):
        base = np.asarray(run({}), np.float32)
        fast = np.asarray(run(opts), np.float32)
        out[stage] = V.deviation(base, fast)
    return out


def _jax_draws(ucfg, u3):
    k_z, k_noise, k_offset, k_uc = jax.random.split(jax.random.PRNGKey(5), 4)
    lat = (1, 4, HW3, HW3)
    tokens = jax.random.normal(jax.random.PRNGKey(1),
                               (1, N_TOK, ucfg.context_dim)) * 0.3
    px = HW5 * 8
    return V.ValidateInputs(
        tokens=t(tokens), vector=torch.zeros((1, ucfg.adm_in_channels)),
        unclip=UnclipNoise(t(jax.random.normal(k_z, lat)),
                           t(jax.random.normal(k_noise, lat)),
                           t(jax.random.normal(k_offset, (1,))),
                           t(jax.random.normal(k_uc, tokens.shape))),
        video_noise=t(jax.random.normal(jax.random.PRNGKey(2),
                                        (1, 4, FRAMES, HW5, HW5))),
        blurry=t(jax.random.uniform(jax.random.PRNGKey(3),
                                    (1, 6, 3, px, px))),
        keyframe=t(jax.random.uniform(jax.random.PRNGKey(4),
                                      (1, 3, px, px))),
        text=t(jax.random.normal(jax.random.PRNGKey(5),
                                 (1, 77, u3.cross_attention_dim)) * 0.1))


def test_score_presets_matches_the_jax_command():
    ucfg, u3 = _jax_configs()
    # the UNet3D cut to its first level: compiling the JAX samplers of the
    # two-level one took most of a minute on the CPU
    u3 = dataclasses.replace(
        u3, block_out_channels=(16,),
        down_block_types=("CrossAttnDownBlock3D",),
        up_block_types=("CrossAttnUpBlock3D",),
        motion_module_resolutions=(1,))
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, 4, FRAMES, HW5, HW5))
    txt0 = jnp.zeros((1, 77, u3.cross_attention_dim))
    p2 = randomize(jax.eval_shape(
        JUNet(ucfg).init, key, jnp.zeros((1, 4, HW3, HW3)), jnp.zeros((1,)),
        jnp.zeros((1, 8, ucfg.context_dim)),
        jnp.zeros((1, ucfg.adm_in_channels)))["params"], 60)
    p3 = randomize(jax.eval_shape(
        JUNet3D(u3, n_frames=FRAMES).init, key, x0, jnp.zeros((1,)),
        txt0)["params"], 61)
    pc = randomize(jax.eval_shape(
        JCN(u3, n_frames=FRAMES).init, key, x0, jnp.zeros((1,)), txt0, x0,
        jnp.zeros((1, 1, FRAMES, HW5, HW5)))["params"], 62)
    tu = port_cfg(tcfg.UNet2DConfig, ucfg)
    t3 = port_cfg(tcfg.UNet3DConfig, u3)
    unet2d = UNetModel(tu, device="cpu").eval()
    unet3d = UNet3DModel(t3, n_frames=FRAMES, device="cpu").eval()
    cn = SparseControlNetModel(t3, n_frames=FRAMES, device="cpu").eval()
    for m, p in ((unet2d, p2), (unet3d, p3), (cn, pc)):
        load_jax_params(m, p)

    presets = {"max": jcli.FAST_PRESETS["max"]}
    got, seconds = V.score_presets(
        unet2d, unet3d, cn, _jax_draws(ucfg, u3), presets, steps3=STEPS3,
        hw3=HW3, steps5=STEPS5, frames=FRAMES, device="cpu")
    opts3, opts5 = V.preset_options(presets["max"], STEPS3, STEPS5)
    assert opts3 == {"tgate_step": 3, "tgate_pab": 2}
    want = _jax_scores(ucfg, u3, p2, p3, pc, opts3, opts5)
    for stage in ("stage3", "stage5"):
        g, w = got["max"][stage], want[stage]
        assert abs(g["rms_rel"] - w["rms_rel"]) <= 1e-4, (stage, g, w)
        assert abs(g["corr"] - w["corr"]) <= 1e-4, (stage, g, w)
        assert g["rms_rel"] > 0.0, (stage, g)   # the preset engaged
    assert set(seconds["stage3"]) == {"exact", "tgate_pab=2,tgate_step=3"}


# --- the parser ------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser a CLI's `main` builds, taken where it parses."""
    box = {}

    def grab(self, *a, **k):
        box["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return box["parser"]


def _commands(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {s for a in p._actions for s in a.option_strings}
            | {a.dest for a in p._actions if not a.option_strings}
            for name, p in sub.choices.items()}


def test_every_jax_subcommand_and_flag_exists_in_the_port(monkeypatch):
    jax_cmds = _commands(_parser_of(jcli.main, monkeypatch))
    port_cmds = _commands(_parser_of(tcli.main, monkeypatch))
    assert len(jax_cmds) == 11
    assert set(jax_cmds) <= set(port_cmds), set(jax_cmds) - set(port_cmds)
    for name, flags in jax_cmds.items():
        assert flags <= port_cmds[name], (name, flags - port_cmds[name])
