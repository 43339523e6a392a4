"""The port's `precompute` slice against the JAX package, on the CPU.

- The open-CLIP importers (`import_open_clip_vision`, `import_open_clip_text`)
  give the JAX importers' trees and unused keys, exactly, on one open_clip
  state dict, which the port's inverse (`open_clip_state_dict`) wrote from
  the JAX trees: the round trip is exact.
- The tiny CLIP vision and text towers, carried from the JAX trees, give
  the JAX towers' outputs within 1e-4 of max |JAX|.
- `data/precompute.py`'s three functions write the JAX functions' tables
  (names, shapes, dtypes) on the same carried weights, within fp16
  rounding (rtol 1e-3, and atol 1e-3 of max |JAX| for the elements near
  zero), a padded tail batch included.
- `data/tasks.py`: the key-object rule and files (json byte-equal, masks
  equal, the .pt as well) and the caption-embedding artifacts equal the
  JAX package's.
- `cli precompute --tiny --synthetic` in both packages on one seeded
  `open_clip_bigG.pt` and tiny `sd_vae.pt`: the four tables equal to fp16
  rounding. The class table is held to the JAX text tower on the same ids
  modulo its vocabulary: the JAX command's tiny tower reads CLIP's start
  and end ids past its 128-row table, which `jnp.take` fills with NaN.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu import cli as jcli
from neurons_tpu.config import VAEConfig as JVAEConfig
from neurons_tpu.data import clip_tokenizer as jtok
from neurons_tpu.data import precompute as jpc
from neurons_tpu.data import tasks as jtasks
from neurons_tpu.interop import torch_import as jti
from neurons_tpu.models import clip as jclip
from neurons_tpu.models.vae import AutoencoderKL as JVAE
from neurons_tpu_torch import cli as tcli
from neurons_tpu_torch.config import VAEConfig
from neurons_tpu_torch.data import clip_tokenizer as ttok
from neurons_tpu_torch.data import precompute as tpc
from neurons_tpu_torch.data import tasks as ttasks
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop import torch_import as tti
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import clip as tclip
from neurons_tpu_torch.models.vae import AutoencoderKL
from test_torch_port_import import assert_equal_trees
from torch_port_utils import randomize, rel_err

TOL = 1e-4
VCFG = dict(block_out_channels=(8, 8), layers_per_block=1, norm_num_groups=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_tokenizers(monkeypatch):
    monkeypatch.setenv("NEURONS_TPU_ALLOW_BYTE_TOKENIZER", "1")
    jtok._tokenizer = ttok._tokenizer = None
    yield
    jtok._tokenizer = ttok._tokenizer = None


@pytest.fixture(scope="module")
def towers():
    """The tiny JAX towers and VAE with every leaf drawn from numpy, and
    the port's modules carrying the same trees."""
    vc, tc = jclip.CLIPVisionConfig.tiny(), jclip.CLIPTextConfig.tiny()
    jv, jt, jvae = (jclip.CLIPVisionTower(vc), jclip.CLIPTextTower(tc),
                    JVAE(JVAEConfig(**VCFG)))
    key = jax.random.PRNGKey(0)
    vp = randomize(jax.eval_shape(jv.init, key, jnp.zeros((1, 3, 32, 32)))
                   ["params"], 20)
    tp = randomize(jax.eval_shape(jt.init, key, jnp.zeros((1, 8), jnp.int32))
                   ["params"], 21)
    ap = randomize(jax.eval_shape(jvae.init, key, jnp.zeros((1, 3, 16, 16)))
                   ["params"], 22)
    tv = tclip.CLIPVisionTower(tclip.CLIPVisionConfig(*vc), device="cpu")
    tt = tclip.CLIPTextTower(tclip.CLIPTextConfig(*tc), device="cpu")
    ta = AutoencoderKL(VAEConfig(**VCFG), device="cpu")
    for m, p in ((tv, vp), (tt, tp), (ta, ap)):
        load_jax_params(m, p)
        m.eval()
    return dict(vc=vc, tc=tc, jv=jv, jt=jt, jvae=jvae, vp=vp, tp=tp, ap=ap,
                tv=tv, tt=tt, ta=ta)


def open_clip_sd(parts):
    return tex.open_clip_state_dict(parts["vp"], parts["vc"].layers,
                                    parts["tp"], parts["tc"].layers)


# --- the importers and their inverse ------------------------------------------

def test_open_clip_importers_equal_jax_and_invert(towers):
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in open_clip_sd(towers).items()}
    sd["visual.attnpool.extra"] = torch.zeros(2)    # unused, reported
    for jfn, tfn, layers, tree in (
            (jti.import_open_clip_vision, tti.import_open_clip_vision,
             towers["vc"].layers, towers["vp"]),
            (jti.import_open_clip_text, tti.import_open_clip_text,
             towers["tc"].layers, towers["tp"])):
        jp, ju = jfn(dict(sd), layers)
        tp, tu = tfn(dict(sd), layers)
        assert_equal_trees(tp, jp)
        assert tu == ju
        assert_equal_trees(tp, tree)
    assert tti.import_open_clip_vision(dict(sd), 2)[1] == ["attnpool.extra"]
    assert tti.import_open_clip_text(dict(sd), 2)[1] == []


def test_open_clip_keys_are_open_clip_layout(towers):
    sd = open_clip_sd(towers)
    for k in ("visual.conv1.weight", "visual.class_embedding",
              "visual.transformer.resblocks.1.attn.in_proj_weight",
              "visual.transformer.resblocks.0.mlp.c_fc.weight",
              "visual.proj", "token_embedding.weight", "text_projection",
              "transformer.resblocks.1.mlp.c_proj.bias", "ln_final.weight"):
        assert k in sd, k
    w = towers["vc"].width
    assert sd["visual.transformer.resblocks.0.attn.in_proj_weight"].shape \
        == (3 * w, w)


# --- the towers -----------------------------------------------------------------

def test_clip_towers_match_jax(towers):
    x = np.random.default_rng(23).uniform(size=(3, 3, 32, 32)).astype(
        np.float32)
    jfn = jax.jit(lambda p, x: towers["jv"].apply(
        {"params": p}, jclip.preprocess_images(x, 32)))
    want = jfn(towers["vp"], jnp.asarray(x))
    with torch.no_grad():
        got = towers["tv"](tclip.preprocess_images(torch.from_numpy(x), 32))
    for g, w in zip(got, want):
        assert rel_err(g, np.asarray(w)) <= TOL
    toks = np.random.default_rng(24).integers(1, 127, (4, 16)).astype(
        np.int64)
    want = jax.jit(lambda p, t: towers["jt"].apply({"params": p}, t))(
        towers["tp"], jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got = towers["tt"](torch.from_numpy(toks))
    for g, w in zip(got, want):
        assert rel_err(g, np.asarray(w)) <= TOL


# --- data/precompute.py -----------------------------------------------------------

def _table_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=1e-3,
                               atol=1e-3 * float(np.abs(want).max()))


def test_precompute_functions_match_jax(towers, tmp_path):
    # 3 clips x 3 frames at batch 4: a tail of one frame, padded
    images = np.random.default_rng(25).uniform(size=(3, 3, 3, 32, 32)
                                               ).astype(np.float32)
    p = towers
    jv = jax.jit(lambda x: p["jv"].apply(
        {"params": p["vp"]}, jclip.preprocess_images(jnp.asarray(x), 32))[1])
    je = jax.jit(lambda x: p["jvae"].apply(
        {"params": p["ap"]}, jnp.asarray(x), method=JVAE.encode).mode())
    jtext = jax.jit(lambda t: p["jt"].apply({"params": p["tp"]},
                                            jnp.asarray(t))[1])

    def tv(x):
        return p["tv"](tclip.preprocess_images(x, 32))[1]

    def te(x):
        return p["ta"].encode(x).mode()

    def tt(t):
        return p["tt"](t)[1]

    def toks(names):
        return np.stack([np.arange(1, 17) + i for i in range(len(names))])

    names = ["car", "dog", "sky"]
    out = {}
    for tag, pc, (fv, fe, ft) in (("jax", jpc, (jv, je, jtext)),
                                  ("port", tpc, (tv, te, tt))):
        d = tmp_path / tag
        d.mkdir()
        out[tag] = (
            pc.precompute_clip_targets(images, fv, str(d / "ct.npy"),
                                       batch_size=4),
            pc.precompute_vae_latents(images, fe, str(d / "vl.npy"),
                                      batch_size=4),
            pc.precompute_class_text_embeds(ft, toks, str(d / "cls.npy"),
                                            class_names=names))
    for got, want in zip(out["port"], out["jax"]):
        assert os.path.basename(got) == os.path.basename(want)
        _table_close(np.load(got), np.load(want))
    assert np.load(out["port"][0]).shape == (3, 3, 16, 32)
    assert np.load(out["port"][1]).dtype == np.float16
    assert np.load(out["port"][2]).dtype == np.float32


# --- data/tasks.py ------------------------------------------------------------------

def _mask(cx, cy, r=2, hw=16):
    m = np.zeros((hw, hw), np.uint8)
    m[max(0, cy - r):cy + r, max(0, cx - r):cx + r] = 1
    return m


def _videos(seed):
    rng = np.random.default_rng(seed)
    cats = ["car", "human", "dog", "building", "tree", "animal"]
    out = {}
    for vid in range(4):
        frames = {}
        for f in range(4):
            frames[f] = {lab: {"segmentation": _mask(
                int(rng.integers(2, 14)), int(rng.integers(2, 14)),
                r=int(rng.integers(1, 8))), "category": cats[(vid + lab) % 6]}
                for lab in range(1, 4) if rng.uniform() < 0.9}
        out[vid] = frames
    return out


def test_key_object_rule_equals_jax():
    for seed in range(6):
        masks = _videos(seed)
        for vid, video in masks.items():
            for k in (1, 3):
                assert (ttasks.select_key_objects_for_video(video, k)
                        == jtasks.select_key_objects_for_video(video, k))
        ti, tm = ttasks.select_key_objects_for_all_videos(
            masks, num_videos=5, n_frames=4, hw=16)
        ji, jm = jtasks.select_key_objects_for_all_videos(
            masks, num_videos=5, n_frames=4, hw=16)
        assert ti == ji
        np.testing.assert_array_equal(tm, jm)


def test_key_object_files_equal_jax(tmp_path):
    from PIL import Image

    mask_dir = tmp_path / "masks"
    mask_dir.mkdir()
    jd = {}
    for vid in range(2):
        for f in range(3):
            for lab, (cat, step) in enumerate((("car", 3), ("human", 1)), 1):
                m = _mask(4 + step * f + vid, 6 + 3 * lab)
                Image.fromarray(m * 255).save(
                    mask_dir / f"mask_{vid}_f{f}_{lab}.png")
                jd.setdefault(f"mask_{vid}_f{f}", {})[str(lab)] = cat
    jpath = tmp_path / "ann.json"
    jpath.write_text(json.dumps(jd))
    for tag, mod in (("jax", jtasks), ("port", ttasks)):
        mod.build_key_object_files(str(mask_dir), str(jpath),
                                   str(tmp_path / tag), "train",
                                   num_videos=3, n_frames=3, hw=16)
    j, t = tmp_path / "jax", tmp_path / "port"
    name = "key_objects_info_train.json"
    assert (t / name).read_bytes() == (j / name).read_bytes()
    assert json.loads((t / name).read_text())["0"]["category"] == "human"
    tm = np.load(t / "key_objects_masks_train.npz")["masks"]
    np.testing.assert_array_equal(
        tm, np.load(j / "key_objects_masks_train.npz")["masks"])
    assert tm.shape == (3, 3, 16, 16) and tm[0].sum() > 0
    np.testing.assert_array_equal(
        torch.load(t / "key_objects_masks_train.pt").numpy(),
        torch.load(j / "key_objects_masks_train.pt").numpy())


def test_caption_embeds_equal_jax(tmp_path):
    caps = [f"a caption {i}" for i in range(5)]

    def embed_np(batch):
        return np.stack([np.full((8,), len(c) / 10.0 + i, np.float32)
                         for i, c in enumerate(batch)])

    want = jtasks.gen_caption_embeds(caps, embed_np, str(tmp_path / "jax"),
                                     "test", batch_size=2)
    got = ttasks.gen_caption_embeds(
        caps, lambda b: torch.from_numpy(embed_np(b)),
        str(tmp_path / "port"), "test", batch_size=2)
    np.testing.assert_array_equal(got, want)
    for name in ("GT_test_caption_qwen.pt", "GT_test_caption_qwen_emb.pt"):
        a = torch.load(tmp_path / "port" / name, weights_only=False)
        b = torch.load(tmp_path / "jax" / name, weights_only=False)
        assert type(a) is type(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- cli precompute -----------------------------------------------------------------

def test_cli_precompute_tiny_equals_jax(towers, tmp_path):
    p = towers
    weights = tmp_path / "weights"
    weights.mkdir()
    torch.save({"state_dict": tex.to_torch(open_clip_sd(p))},
               weights / "open_clip_bigG.pt")
    vae_sd = tex.ldm_vae_state_dict(p["ap"], VAEConfig(**VCFG))
    torch.save(tex.to_torch({"first_stage_model." + k: v
                             for k, v in vae_sd.items()}),
               weights / "sd_vae.pt")
    roots = {}
    for tag, main in (("jax", jcli.main), ("port", tcli.main)):
        roots[tag] = tmp_path / f"root_{tag}"
        main(["precompute", "--tiny", "--synthetic", "--platform", "cpu",
              "--weights_dir", str(weights), "--root_dir", str(roots[tag])])
    for split in ("train", "test"):
        for name in (f"clip_targets_{split}.npy", f"vae_latents_{split}.npy"):
            got = np.load(roots["port"] / name)
            _table_close(got, np.load(roots["jax"] / name))
            n = 32 if split == "train" else 16
            assert got.shape[:2] == (n, 6) and np.isfinite(got).all()
    got = np.load(roots["port"] / "class_text_embeds.npy")
    assert got.shape == (51, 24) and got.dtype == np.float32
    toks = np.stack(jcli._pad_tokens(jtok.tokenize(_class_names()),
                                     16)) % 128
    want = jax.jit(lambda q, t: p["jt"].apply({"params": q}, t)[1])(
        p["tp"], jnp.asarray(toks))
    assert rel_err(got, np.asarray(want)) <= TOL


def _class_names():
    from neurons_tpu.data.categories import CLS_DICT
    return [CLS_DICT[i] for i in sorted(CLS_DICT)]


def test_chip_smoke_precompute_files_feed_the_cli(tmp_path):
    """chip_smoke.py's precompute phase at tiny widths on the CPU: its
    CC2017 root with a train split and its seeded `open_clip_bigG.pt` and
    `sd_vae.pt` drive `precompute --tiny` through the loading branches
    (not --synthetic: the tables come from the root's frames); the tables
    have the splits' clip counts, and `precompute_launches` counts the
    tower calls the command makes."""
    import chip_smoke
    from neurons_tpu_torch.models.clip import CLIPTextConfig, CLIPVisionConfig

    root, weights = tmp_path / "root", tmp_path / "weights"
    vc, tc = CLIPVisionConfig.tiny(), CLIPTextConfig.tiny()
    chip_smoke.write_cc2017_root(root, 2, np.random.default_rng(0),
                                 txt_dim=24, n_train=3, img=32)
    files = chip_smoke.write_precompute_weights(
        weights, vc, tc, VAEConfig(**VCFG), device="cpu")
    assert sorted(files) == ["open_clip_bigG.pt", "sd_vae.pt"]
    tcli._LOAD_STATS.clear()
    tcli.main(["precompute", "--tiny", "--platform", "cpu", "--root_dir",
               str(root), "--weights_dir", str(weights), "--seed", "0"])
    assert sorted(tcli._LOAD_STATS) == ["SD VAE", "open_clip bigG"]
    for split, n in (("train", 3), ("test", 2)):
        ct = np.load(root / f"clip_targets_{split}.npy")
        vl = np.load(root / f"vae_latents_{split}.npy")
        assert ct.shape == (n, 6, 16, 32) and ct.dtype == np.float16
        assert vl.shape == (n, 6, 4, 16, 16) and np.isfinite(vl).all()
    stats = tcli._STAGE_STATS["precompute"]
    assert stats["tables"]["clip_targets_train"]["frames"] == 18
    counted = chip_smoke.precompute_launches([18, 12], vc, 4, vae_side=16)
    # the tiny tower's 17 tokens and the VAE's 16^2 latents at batch 4:
    # 5 + 3 batches and a probe a split
    assert counted["flash_attn_fwd"][(4, 4, 17, 17, 8, "float32", "")] == \
        (5 + 3) * vc.layers
    assert counted["flash_attn_fwd"][(1, 1, 256, 256, 512, "float32",
                                      "")] == 2
