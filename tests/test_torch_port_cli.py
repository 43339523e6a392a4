"""The port's CLI (`neurons_tpu_torch/cli.py`) and the modules its stages
3, 5, e, 1 and 2 brought in, against the JAX package, on the CPU.

Each against its JAX twin: the artifact resize (`resize_np` bitwise,
`resize_reference` within 1e-6 of max |JAX|), the CLIP BPE tokenizer on a
small merges file (equal ids), `load_split` / `tokenize_captions` /
`_multi_hot` on a fake dataset root (equal arrays), stage e's
`generate_decoupled_outputs` with the JAX draws fed in (outputs within
1e-5 of max |JAX|, Dice within 1e-5, the thresholded scores equal),
`table_stage2_batch_builder` (equal), `_apply_fast_preset` (equal knobs,
re-entrant across `pipeline`) and `_load_decoupler_params` (the port's
stage-2 tag, its mid-run error, and the reference ensemble equal to the
JAX CLI's overlay). Then the CLI itself: `recon` on tiny weight files
gives bitwise the keyframes `reconstruct_keyframes` gives on the same
modules and draws; `pipeline 12345e6 --tiny --synthetic --platform cpu`
runs to its end and the JAX package reads its artifacts and GIFs; and
without --tiny/--synthetic a missing checkpoint, class table, GT video,
blurry video or test-mask file raises, as `--platform cuda` does without
a card.
"""

import argparse
import json
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import cli as jcli
from neurons_tpu.data import cc2017 as jcc
from neurons_tpu.data import clip_tokenizer as jtok
from neurons_tpu.ops import resize as jresize
from neurons_tpu.pipelines import decoupled_eval as jde
from neurons_tpu.training import loop as jloop
from neurons_tpu_torch import cli as tcli
from neurons_tpu_torch.data import cc2017 as tcc
from neurons_tpu_torch.data import clip_tokenizer as ttok
from neurons_tpu_torch.interop import load_weights as tlw
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop import torch_import as tti
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.ops import resize as tresize
from neurons_tpu_torch.pipelines import decoupled_eval as tde
from neurons_tpu_torch.training import loop as tloop
from test_real_layout import hf_root  # noqa: F401  (a fixture)
from test_torch_port_import import assert_equal_trees, seeded
from test_torch_port_keyframe import slice_parts
from torch_port_utils import ensure_jax_native_io, rel_err, t


@pytest.fixture(autouse=True, scope="module")
def _jax_native_codec():
    """The JAX package's native codec whole before this module's tests
    reach it (`torch_port_utils.ensure_jax_native_io`)."""
    ensure_jax_native_io()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_tokenizers():
    """Both packages cache their tokenizer; each test starts without."""
    jtok._tokenizer = ttok._tokenizer = None
    yield
    jtok._tokenizer = ttok._tokenizer = None


# --- the artifact resize -------------------------------------------------------

@pytest.mark.parametrize("src,dst,aa", [(768, 256, False), (224, 256, False),
                                        (512, 224, True), (64, 64, False)])
def test_resize(src, dst, aa):
    x = np.random.default_rng(src).uniform(
        size=(2, 3, src, src)).astype(np.float32)
    assert np.array_equal(tresize.resize_np(x, (dst, dst), aa),
                          jresize.resize_np(x, (dst, dst), aa))
    ref = np.asarray(jresize.resize_reference(jnp.asarray(x), (dst, dst),
                                              aa))
    got = tresize.resize_reference(torch.from_numpy(x), (dst, dst), aa)
    assert got.dtype == torch.float32 and rel_err(got, ref) <= 1e-6


# --- the tokenizer ---------------------------------------------------------------

MERGES = ["#version: 0.2", "t h", "th e</w>", "c a", "ca t</w>", "a t</w>",
          "o n", "on e</w>", "s a", "sa t</w>"]
TEXTS = ["The cat sat on one mat.", "a  CAT, the &amp; cats!", "x9 y10"]


def test_tokenizer_on_a_merges_file(tmp_path, monkeypatch):
    path = tmp_path / "bpe.txt"
    path.write_text("\n".join(MERGES) + "\n")
    jt, tt = jtok.SimpleTokenizer(str(path)), ttok.SimpleTokenizer(str(path))
    for text in TEXTS:
        assert tt.encode(text) == jt.encode(text)
        assert tt.decode(tt.encode(text)) == jt.decode(jt.encode(text))
    monkeypatch.setenv("CLIP_BPE_PATH", str(path))
    got = ttok.tokenize(TEXTS, context_length=8)
    assert got == jtok.tokenize(TEXTS, context_length=8)
    assert all(r[0] == ttok.SOT and r[-1] == ttok.EOT for r in got)


def test_tokenizer_gate(monkeypatch, tmp_path):
    monkeypatch.setenv("CLIP_BPE_PATH", str(tmp_path / "absent.txt.gz"))
    monkeypatch.delenv("NEURONS_TPU_ALLOW_BYTE_TOKENIZER")
    with pytest.raises(FileNotFoundError, match="CLIP_BPE_PATH"):
        ttok.tokenize(["a cat"])
    monkeypatch.setenv("NEURONS_TPU_ALLOW_BYTE_TOKENIZER", "1")
    with pytest.warns(UserWarning, match="fallback"):
        got = ttok.tokenize(["a cat"])
    assert got == jtok.tokenize(["a cat"])


# --- the dataset loader ------------------------------------------------------------

@pytest.mark.parametrize("train", [True, False])
def test_load_split(hf_root, train):  # noqa: F811
    j = jcc.load_split(str(hf_root), 1, train)
    p = tcc.load_split(str(hf_root), 1, train)
    for f in ("voxel", "images", "text_emb", "clip_tokens", "cls_label",
              "key_obj_masks", "key_obj_cls"):
        a, b = getattr(p, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert np.array_equal(tcc.tokenize_captions(str(hf_root), "test"),
                          jcc.tokenize_captions(str(hf_root), "test"))
    for ids in ([3, 60, -1, 50], 7, []):
        assert np.array_equal(tcc._multi_hot(ids), jcc._multi_hot(ids))


# --- stage e -------------------------------------------------------------------

def test_generate_decoupled_outputs():
    from neurons_tpu_torch.diffusion.prior import PriorNoise

    p = slice_parts(38)
    c, n_frames, steps, b = p.cfg.brain, p.cfg.decoupler.n_frames, 4, 2
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(6)
    masks = (rng.uniform(size=(b, 6, 32, 32)) < 0.4).astype(np.float32)
    cls = (rng.uniform(size=(b, p.cfg.decoupler.num_classes)) < 0.4
           ).astype(np.float32)
    ref = jde.generate_decoupled_outputs(
        decoupler_apply=lambda prm, m, *a, **kw: p.jdec.apply(
            {"params": prm}, *a, method=m, **kw),
        decoupler_params=p.dparams, key=key, voxel=jnp.asarray(p.voxel),
        class_text_embeds=jnp.asarray(p.class_embeds), n_frames=n_frames,
        prior_steps=steps, caption_len=8,
        gt_masks=jnp.asarray(masks[:, :n_frames]), gt_cls=jnp.asarray(cls))
    k_init, k_loop = jax.random.split(key)
    shape = (b, c.clip_seq_dim, c.clip_emb_dim)
    noise = PriorNoise(t(jax.random.normal(k_init, shape)),
                       [t(jax.random.normal(jax.random.fold_in(k_loop, i),
                                            shape)) for i in range(steps)])
    got = tde.generate_decoupled_outputs(
        p.tdec, torch.from_numpy(p.voxel), torch.from_numpy(p.class_embeds),
        n_frames=n_frames, prior_steps=steps, caption_len=8,
        gt_masks=torch.from_numpy(masks), gt_cls=torch.from_numpy(cls),
        noise=noise, device="cpu")
    for f in ("seg_masks", "cls_logits", "blurry_latents"):
        assert rel_err(getattr(got, f), getattr(ref, f)) <= 1e-5, f
    assert np.array_equal(got.captions.numpy(), np.asarray(ref.captions))
    assert abs(float(got.dice) - float(ref.dice)) <= 1e-5 * abs(
        float(ref.dice))
    for f in ("cls_accuracy", "cls_precision", "cls_recall"):
        assert float(getattr(got, f)) == float(getattr(ref, f)), f


# --- stage 2's table builder ---------------------------------------------------------

def test_table_stage2_batch_builder(tmp_path):
    from neurons_tpu.config import DecouplerConfig as JD
    from neurons_tpu_torch.config import DecouplerConfig as TD
    g = np.random.default_rng(7)
    n = 8
    np.save(tmp_path / "clip_targets_train.npy",
            g.normal(size=(n, 6, 4, 8)).astype(np.float32))
    np.save(tmp_path / "vae_latents_train.npy",
            g.normal(size=(n, 6, 4, 2, 2)).astype(np.float32))
    np.save(tmp_path / "class_text_embeds.npy",
            g.normal(size=(51, 6)).astype(np.float32))
    split = tcc.synthetic_split(n=n, n_voxels=10, n_classes=51, seed=3)
    batch = next(tcc.batches(split, 4, seed=1))
    jb = jloop.table_stage2_batch_builder(str(tmp_path), JD(n_frames=2), 50)
    tb = tloop.table_stage2_batch_builder(str(tmp_path), TD(n_frames=2), 50)
    a, b = tb(dict(batch), 0), jb(dict(batch), 0)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# --- CLI helpers -------------------------------------------------------------------

def _ns(**kw):
    base = dict(fast=None, tgate=0, tgate_pab=0, tiny=True, synthetic=True,
                encoder_reuse=1, pab=None, pab_range=None, deep_cache=0,
                n_test=0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("preset", ["quality", "balanced", "max"])
@pytest.mark.parametrize("explicit", [0, 7])
def test_apply_fast_preset(preset, explicit):
    a, b = _ns(fast=preset, tgate=explicit), _ns(fast=preset, tgate=explicit)
    for stage in ("recon", "video", "recon"):  # re-entrant, as `pipeline`
        tcli._apply_fast_preset(a, stage)
        jcli._apply_fast_preset(b, stage)
        assert vars(a) == vars(b), stage
    if explicit:
        assert a.tgate == explicit


@pytest.mark.parametrize("n_test,synthetic,available", [
    (0, True, 10), (0, False, 1200), (3, False, 1200), (50, True, 16)])
def test_test_clip_count(n_test, synthetic, available):
    a = _ns(n_test=n_test, synthetic=synthetic, tiny=False)
    assert tcli._test_clip_count(a, available) == jcli._test_clip_count(
        a, available)


def _cli_args(tmp_path, **kw):
    base = dict(exp_dir=str(tmp_path / "EXP"), exp="t",
                weights_dir=str(tmp_path / "w"), root_dir=str(tmp_path / "r"),
                tiny=True, synthetic=True, n_blocks=4, hidden_dim=4096,
                n_frames=6, subj=1, seed=42, batch_size=10, num_epochs=1,
                max_lr=3e-4, mixup_pct=0.33, prior_scale=30.0,
                lr_scheduler_type="cycle", ckpt_saving=True, n_test=0,
                platform="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _tiny_decoupler(args):
    from neurons_tpu_torch.models.neurons import NeuronsDecoupler
    bcfg, pcfg, dcfg, _ = tcli._configs(args, stage2=True)
    return NeuronsDecoupler(bcfg, pcfg, dcfg, tcli._gpt2_config(args),
                            device="cpu").eval()


def test_load_decoupler_params_stage2_tag_and_mid_run_error(tmp_path):
    from neurons_tpu_torch.utils import checkpoint as ck
    args = _cli_args(tmp_path)
    bcfg, pcfg, _, _ = tcli._configs(args, stage2=True)
    gcfg = tcli._gpt2_config(args)
    ckpt_dir = os.path.join(args.exp_dir, "exp_t", "checkpoints")
    trained = seeded(_tiny_decoupler(args), 1)
    heads = {n: p for n, p in trained.named_parameters()
             if not n.startswith("core.")}
    ck.save_ckpt(ckpt_dir, "brain_model_prior_last", params=heads)
    with pytest.raises(RuntimeError, match="refusing to leave"):
        tcli._load_decoupler_params(args, _tiny_decoupler(args), bcfg, pcfg,
                                    gcfg)
    ck.save_ckpt(ckpt_dir, "brain_model_core",
                 params={n[len("core."):]: p for n, p in
                         trained.named_parameters() if n.startswith("core.")})
    got = tcli._load_decoupler_params(args, _tiny_decoupler(args), bcfg,
                                      pcfg, gcfg)
    assert all(torch.equal(a, b) for a, b in zip(got.parameters(),
                                                  trained.parameters()))


def test_load_decoupler_params_reference_ensemble(tmp_path):
    from neurons_tpu.models.neurons import NeuronsDecoupler as JND
    args = _cli_args(tmp_path)
    bcfg, pcfg, _, _ = tcli._configs(args, stage2=True)
    gcfg = tcli._gpt2_config(args)
    src = seeded(_tiny_decoupler(args), 2)
    os.makedirs(args.weights_dir)
    sd = tex.neurons_ensemble_state_dict(
        tex.jax_tree(src), n_blocks=bcfg.n_blocks, prior_depth=pcfg.depth,
        gpt2_layers=gcfg.n_layer)
    torch.save(tex.to_torch(sd), os.path.join(args.weights_dir,
                                              "brain_model_prior_last.pth"))
    got = tcli._load_decoupler_params(args, seeded(_tiny_decoupler(args), 3),
                                      bcfg, pcfg, gcfg)
    jb, jp, jd, _ = jcli._configs(args, stage2=True)
    jmodel = JND(jb, jp, jd, _jgpt2())
    init = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, jb.voxel_counts[0])),
        jnp.zeros((1, 8), jnp.int32))["params"])
    want = jcli._load_decoupler_params(args, init, jb, jp, gcfg)
    assert_equal_trees(tex.jax_tree(got), jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), want))


def _jgpt2():
    from neurons_tpu.models.gpt2 import tiny_gpt2_config
    return tiny_gpt2_config()


# --- the CLI -----------------------------------------------------------------------

def _write_tiny_stage3_files(args):
    """The unclip6 checkpoint and the reference ensemble at the CLI's tiny
    stage-3 widths, from seeded port modules."""
    from neurons_tpu_torch.config import UNet2DConfig, VAEConfig
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.vae import AutoencoderKL
    bcfg, pcfg, _, _ = tcli._configs(args, stage2=True)
    gcfg = tcli._gpt2_config(args)
    ucfg = UNet2DConfig(model_channels=8, channel_mult=(1, 2),
                        num_res_blocks=1, transformer_depth=(1, 1),
                        num_head_channels=4, context_dim=bcfg.clip_emb_dim,
                        adm_in_channels=1024, attention_resolutions=(2,))
    vcfg = VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                     norm_num_groups=4)
    w = Path(args.weights_dir)
    w.mkdir(parents=True, exist_ok=True)
    unet = seeded(UNetModel(ucfg, device="cpu"), 4)
    live = seeded(UNetModel(ucfg, device="cpu"), 7)
    vae = seeded(AutoencoderKL(vcfg, device="cpu"), 5)

    def ldm(m):
        return {"model.diffusion_model." + k: v for k, v in
                tex.ldm_unet_state_dict(tex.jax_tree(m), ucfg).items()}

    sd = {**ldm(live), **tex.ema_state_dict(ldm(unet))}
    sd.update({"first_stage_model." + k: v for k, v in
               tex.ldm_vae_state_dict(tex.jax_tree(vae), vcfg).items()})
    torch.save({"state_dict": tex.to_torch(sd)},
               w / "unclip6_epoch0_step110000.ckpt")
    dec = seeded(_tiny_decoupler(args), 6)
    torch.save(tex.to_torch(tex.neurons_ensemble_state_dict(
        tex.jax_tree(dec), n_blocks=bcfg.n_blocks, prior_depth=pcfg.depth,
        gpt2_layers=gcfg.n_layer)), w / "brain_model_prior_last.pth")
    return ucfg, vcfg


def test_recon_equals_the_library_call(tmp_path):
    from neurons_tpu_torch.config import SamplerConfig
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.vae import AutoencoderKL
    from neurons_tpu_torch.pipelines import io
    from neurons_tpu_torch.pipelines.keyframe import (draw_keyframe_noise,
                                                      reconstruct_keyframes)
    from neurons_tpu_torch.utils.prng import stage_generator

    args = _cli_args(tmp_path)
    ucfg, vcfg = _write_tiny_stage3_files(args)
    tcli.main(["recon", "--tiny", "--synthetic", "--platform", "cpu",
               "--exp_dir", args.exp_dir, "--exp", "t", "--weights_dir",
               args.weights_dir, "--root_dir", args.root_dir])
    art = io.load_stage3_artifacts(io.stage3_dir(args.exp_dir, "t", 1,
                                                 False), 1)

    bcfg, pcfg, dcfg, tcfg = tcli._configs(args, stage2=True)
    gcfg = tcli._gpt2_config(args)
    dec = _tiny_decoupler(args)
    sd = torch.load(os.path.join(args.weights_dir,
                                 "brain_model_prior_last.pth"))
    tree, _ = tti.import_neurons_ensemble(
        sd, n_blocks=bcfg.n_blocks, prior_depth=pcfg.depth,
        gpt2_layers=gcfg.n_layer)
    load_jax_params(dec, tree)
    up, vp, _ = tlw.load_unclip_engine(os.path.join(
        args.weights_dir, "unclip6_epoch0_step110000.ckpt"), ucfg, vcfg)
    unet = UNetModel(ucfg, device="cpu").eval()
    vae = AutoencoderKL(vcfg, device="cpu").eval()
    load_jax_params(unet, up)
    load_jax_params(vae, vp)
    split = tcli._load_data(args, bcfg, tcfg, train=False)
    vox = torch.from_numpy(split.voxel[:4, :1])
    scfg = SamplerConfig(unclip_steps=3, prior_steps=4)
    noise = draw_keyframe_noise(4, bcfg.clip_seq_dim, bcfg.clip_emb_dim,
                                scfg.prior_steps, 8,
                                stage_generator(42, "3", 0))
    classes = torch.from_numpy(np.random.default_rng(0).normal(
        size=(51, 24)).astype(np.float32))
    out = reconstruct_keyframes(dec, unet, vae, vox, classes, scfg,
                                latent_hw=8, caption_len=12, noise=noise,
                                device="cpu")
    assert torch.equal(torch.from_numpy(art["all_recons"]), out.keyframes)
    assert art["captions"][0] == ("tokens:" + str(
        [int(x) for x in out.captions[0, :8]]))


def test_pipeline_12345e6_tiny_on_the_cpu(tmp_path):
    from neurons_tpu.evaluation.runner import run_metrics as jrun_metrics
    from neurons_tpu.pipelines import io as jio

    exp = str(tmp_path / "EXP")
    report = tmp_path / "report.json"
    os.environ["NEURONS_TPU_PIPELINE_REPORT"] = str(report)
    try:
        tcli.main(["pipeline", "12345e6", "--tiny", "--synthetic",
                   "--platform", "cpu", "--num_epochs", "1", "--exp_dir",
                   exp, "--weights_dir", str(tmp_path / "w"), "--root_dir",
                   str(tmp_path / "r")])
    finally:
        del os.environ["NEURONS_TPU_PIPELINE_REPORT"]
    rows = json.loads(report.read_text())
    assert [r["stage"] for r in rows] == list("12345e6")
    st3 = jio.stage3_dir(exp, "exp1", 1, False)
    art = jio.load_stage3_artifacts(st3, 1)
    assert art["all_recons"].shape == (4, 3, 16, 16)
    assert art["blurry_videos"].shape[:3] == (4, 2, 3)
    assert len(jio.load_captions(st3, "blip")) == 4
    assert all(c.startswith("tokens:") for c in jio.load_captions(st3,
                                                                  "self"))
    vdir = jio.video_dir(exp, "exp1", 1, "motion")
    gifs = sorted(os.listdir(vdir))
    assert len(gifs) == 2 and all(g.endswith(".gif") for g in gifs)
    ref = jrun_metrics(vdir, verbose=False)
    with open(os.path.join(jio.exp_dir(exp, "exp1", 1),
                           "metrics_motion.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(ref) == ["psnr", "ssim"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-4 * max(1.0, abs(ref[k])), k
    e = next(r for r in rows if r["stage"] == "e")
    assert 0.0 <= e["dice"] <= 1.0 and len(e["cls_pred"]) == 4


# --- no fallback ---------------------------------------------------------------

@pytest.fixture()
def real_root(hf_root, tmp_path):  # noqa: F811
    root = tmp_path / "root"
    shutil.copytree(hf_root, root)
    return root


def _run(cmd, tmp_path, root, *extra):
    tcli.main([cmd, "--platform", "cpu", "--exp_dir", str(tmp_path / "EXP"),
               "--weights_dir", str(tmp_path / "w"), "--root_dir", str(root),
               *extra])


def test_recon_without_its_files_raises(tmp_path, real_root):
    with pytest.raises(FileNotFoundError, match="class_text_embeds"):
        _run("recon", tmp_path, real_root)
    np.save(real_root / "class_text_embeds.npy",
            np.zeros((51, 1280), np.float32))
    with pytest.raises(FileNotFoundError, match="unclip6"):
        _run("recon", tmp_path, real_root)


def test_video_without_its_files_raises(tmp_path, real_root):
    from neurons_tpu_torch.pipelines import io
    with pytest.raises(FileNotFoundError, match="v3_sd15_mm"):
        _run("video", tmp_path, real_root)
    (tmp_path / "w").mkdir()
    (tmp_path / "w" / "v3_sd15_mm.ckpt").write_bytes(b"")
    with pytest.raises(FileNotFoundError):  # no stage-3 artifacts
        _run("video", tmp_path, real_root)
    st3 = io.stage3_dir(str(tmp_path / "EXP"), "exp1", 1, False)
    g = np.random.default_rng(0)
    io.save_stage3_artifacts(
        st3, 1, all_recons=g.uniform(size=(2, 3, 8, 8)).astype(np.float32),
        all_gts=g.uniform(size=(2, 3, 8, 8)).astype(np.float32),
        captions=["a", "b"],
        blurry_videos=g.uniform(size=(2, 6, 3, 8, 8)).astype(np.float32))
    os.remove(os.path.join(st3, "video_subj01_all_gts.pt"))
    os.remove(real_root / "GT_test_3fps.pt")
    with pytest.raises(RuntimeError, match="no GT source"):
        _run("video", tmp_path, real_root)
    os.remove(os.path.join(st3, "recon_videos.pt"))
    with pytest.raises(FileNotFoundError):
        _run("video", tmp_path, real_root)


def test_decoupled_eval_without_test_masks_raises(tmp_path, real_root):
    os.remove(real_root / "masks" / "key_objects_masks_qwen_test.pt")
    with pytest.raises(FileNotFoundError, match="qwen_test"):
        _run("decoupled-eval", tmp_path, real_root)


def test_platform_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["recon", "--tiny", "--synthetic", "--exp_dir",
                   str(tmp_path / "EXP")])


def test_chip_smoke_files_feed_the_cli(tmp_path, monkeypatch):
    """chip_smoke.py's CLI phase at the CLI's tiny widths on the CPU: its
    CC2017 root and reference weight files (the exporters' layouts) drive
    `pipeline 35e6 --tiny` through the real-weight branches of stages 3
    (unclip6 checkpoint, reference ensemble), 5 (the SD-1.5 base, motion
    module, LoRA, SparseCtrl) and e; its output checks pass."""
    import chip_smoke
    from neurons_tpu_torch.config import UNet2DConfig, UNet3DConfig, VAEConfig
    from neurons_tpu_torch.models.clip import CLIPTextConfig

    args = _cli_args(tmp_path)
    bcfg, pcfg, dcfg, _ = tcli._configs(args, stage2=True)
    cfgs = dict(
        unet2d=UNet2DConfig(model_channels=8, channel_mult=(1, 2),
                            num_res_blocks=1, transformer_depth=(1, 1),
                            num_head_channels=4,
                            context_dim=bcfg.clip_emb_dim,
                            adm_in_channels=1024, attention_resolutions=(2,)),
        vae=VAEConfig(block_out_channels=(8, 8), layers_per_block=1,
                      norm_num_groups=4),
        unet3d=UNet3DConfig(block_out_channels=(8, 16, 16, 16),
                            layers_per_block=1, cross_attention_dim=12,
                            attention_head_dim=4, norm_num_groups=4,
                            motion_num_attention_heads=2,
                            motion_max_seq_length=8),
        n_frames=4, brain=bcfg, prior=pcfg, decoupler=dcfg,
        gpt2=tcli._gpt2_config(args), text=CLIPTextConfig.tiny())
    root, weights = tmp_path / "root", tmp_path / "weights"
    merges = chip_smoke.write_cc2017_root(root, 2, np.random.default_rng(0),
                                          txt_dim=bcfg.clip_txt_emb_dim)
    files = chip_smoke.write_reference_weights(weights, cfgs, device="cpu",
                                               classifiers=False)
    assert sorted(files) == sorted([
        "unclip6_epoch0_step110000.ckpt",
        "realisticVisionV60B1_v51VAE.safetensors", "v3_sd15_mm.ckpt",
        "v3_sd15_adapter.ckpt", "v3_sd15_sparsectrl_rgb.ckpt",
        "brain_model_prior_last.pth"])
    monkeypatch.setenv("CLIP_BPE_PATH", str(merges))
    exp = str(tmp_path / "EXP")
    tcli._LOAD_STATS.clear()
    tcli.main(["pipeline", "35e6", "--tiny", "--platform", "cpu",
               "--n_test", "2", "--root_dir", str(root), "--weights_dir",
               str(weights), "--exp_dir", exp, "--seed", "0"])
    assert sorted(tcli._LOAD_STATS) == [
        "AnimateDiff UNet3D", "SD VAE", "SparseCtrl",
        "brain_model_prior_last.pth", "unclip engine"]
    report, art = chip_smoke.check_cli_outputs(exp, 2, 16, 4, 2,
                                               "tiny files")
    assert sorted(report) == ["psnr", "ssim"]
