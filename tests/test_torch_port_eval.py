"""Parity of the port's stage 6 (neurons_tpu_torch.evaluation, the metric
classifiers and their HF importers) with the JAX package, on the CPU.

Pixel metrics (SSIM, PSNR) are held within 1e-5; the n-way protocol and
the scene dedup must agree exactly, both packages given the same numpy
classifier callables; the classifier towers, in f32 at tiny size with the
same weights (`torch_port_utils.randomize` through `load_jax_params`),
within 1e-4 of their largest magnitude; the importers' trees leaf for
leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.evaluation import metrics as JM
from neurons_tpu.evaluation import runner as JR
from neurons_tpu.interop import torch_import as jti
from neurons_tpu.models import clip as jclip
from neurons_tpu.models import vit as jvit
from neurons_tpu.pipelines import io as jio
from neurons_tpu_torch.evaluation import metrics as TM
from neurons_tpu_torch.evaluation import runner as TR
from neurons_tpu_torch.interop import torch_import as tti
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import clip as tclip
from neurons_tpu_torch.models import vit as tvit
from neurons_tpu_torch.pipelines import io as tio
from torch_port_utils import ensure_jax_native_io, randomize, rel_err
from test_torch_port_caption import assert_trees_equal

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _jax_native_codec():
    """The JAX package's native codec whole before this module's tests
    reach it (`torch_port_utils.ensure_jax_native_io`)."""
    ensure_jax_native_io()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(seed, n=3, hw=40):
    """Two related frame stacks [n, hw, hw, 3] in 0-255 (f32)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 255, (n, hw, hw, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 30, a.shape), 0, 255).astype(np.float32)
    return a, b


# --- pixel metrics -----------------------------------------------------------

def test_gaussian_kernel_and_channel_last():
    np.testing.assert_array_equal(TM._gaussian_kernel1d(),
                                  JM._gaussian_kernel1d())
    np.testing.assert_array_equal(TM._gaussian_kernel1d(2.0, 2.0),
                                  JM._gaussian_kernel1d(2.0, 2.0))
    for shape in ((3, 8, 9), (2, 3, 8, 9), (8, 9, 3), (2, 8, 9, 3)):
        x = np.arange(np.prod(shape)).reshape(shape)
        np.testing.assert_array_equal(TM._channel_last(x),
                                      JM._channel_last(x))


def test_rgb2gray_filter_and_ssim_gray_match_jax():
    a, b = frames(0)
    ga, gb = TM.rgb2gray(torch.from_numpy(a)), TM.rgb2gray(torch.from_numpy(b))
    ja, jb = JM.rgb2gray(jnp.asarray(a)), JM.rgb2gray(jnp.asarray(b))
    np.testing.assert_allclose(ga.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    k = JM._gaussian_kernel1d()
    np.testing.assert_allclose(
        TM._filter2d_nearest(ga[0], k).numpy(),
        np.asarray(JM._filter2d_nearest(ja[0], k)), rtol=0, atol=1e-6)
    got = TM.ssim_gray(ga, gb).numpy()
    want = [float(JM.ssim_gray(ja[i], jb[i])) for i in range(len(a))]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", ["hwc", "chw"])
def test_ssim_psnr_mse_scores_match_jax(layout):
    a, b = frames(1, n=4)
    if layout == "chw":
        a, b = a.transpose(0, 3, 1, 2), b.transpose(0, 3, 1, 2)
    for tfn, jfn in ((TM.ssim_score, JM.ssim_score),
                     (TM.psnr_score, JM.psnr_score)):
        got, want = tfn(a, b, device="cpu"), jfn(a, b)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(TM.mse_score(a, b), JM.mse_score(a, b),
                               rtol=0, atol=0)
    # identical frames: PSNR through the 1e-12 floor (168 dB, where one
    # f32 ulp is 1.5e-5: within an ulp), SSIM 1
    assert TM.psnr_score(a, a, device="cpu")[0] == pytest.approx(
        JM.psnr_score(a, a)[0], rel=2 ** -23)
    assert TM.ssim_score(a, a, device="cpu")[0] == pytest.approx(1.0,
                                                                 abs=1e-6)


def test_psnr_matches_jax():
    a, b = frames(2, n=1)
    np.testing.assert_allclose(
        float(TM.psnr(torch.from_numpy(a[0]), torch.from_numpy(b[0]))),
        float(JM.psnr(jnp.asarray(a[0]), jnp.asarray(b[0]))),
        rtol=0, atol=1e-5)


# --- the n-way protocol and the other host metrics ---------------------------

class Classifiers:
    """Numpy classifiers both packages share: fixed random projections of
    subsampled pixels to 100 classes (frames), 60 (videos) and a 16-d
    embedding."""

    def __init__(self, seed, hw, f):
        rng = np.random.default_rng(seed)
        n = (hw // 4) ** 2 * 3
        self.wi = rng.standard_normal((n, 100)) / np.sqrt(n)
        self.wv = rng.standard_normal((f * n, 60)) / np.sqrt(f * n)
        self.we = rng.standard_normal((n, 16)) / np.sqrt(n)

    @staticmethod
    def _soft(z):
        e = np.exp(z - z.max())
        return e / e.sum()

    def img_logits(self, frame):
        return frame[::4, ::4].reshape(-1) / 255.0 @ self.wi

    def vid_logits(self, video):
        return video[:, ::4, ::4].reshape(-1) / 255.0 @ self.wv

    def embed(self, video):
        return video[:, ::4, ::4].reshape(len(video), -1) / 255.0 @ self.we

    def for_port(self):
        return TR.MetricClassifiers(
            img_probs_fn=lambda f: self._soft(self.img_logits(f)),
            img_logits_fn=self.img_logits,
            video_probs_fn=lambda v: self._soft(self.vid_logits(v)),
            video_logits_fn=self.vid_logits, clip_embed_fn=self.embed)

    def for_jax(self):
        return JR.MetricClassifiers(**vars(self.for_port()))


@pytest.mark.parametrize("n_way,top_k", [(2, 1), (50, 1), (50, 5)])
def test_n_way_protocol_is_exact(n_way, top_k):
    c = Classifiers(3, 24, 4)
    rng = np.random.default_rng(4)
    pred = rng.uniform(0, 255, (5, 24, 24, 3))
    gt = rng.uniform(0, 255, (5, 24, 24, 3))
    probs = c._soft(c.img_logits(pred[0]))
    assert (TM.n_way_top_k_acc(probs, [3, 7], n_way, 40, top_k,
                               np.random.default_rng(1))
            == JM.n_way_top_k_acc(probs, [3, 7], n_way, 40, top_k,
                                  np.random.default_rng(1)))
    assert TM.n_way_top_k_acc(probs, 5, n_way) == JM.n_way_top_k_acc(
        probs, 5, n_way)
    cl = c.for_port()
    args = (cl.img_probs_fn, cl.img_logits_fn, list(pred), list(gt))
    kw = dict(n_way=n_way, num_trials=30, top_k=top_k, seed=2)
    assert TM.classify_nway_metric(*args, **kw) == \
        JM.classify_nway_metric(*args, **kw)


def test_clip_metrics_and_remove_overlap_are_exact():
    c = Classifiers(5, 24, 4)
    rng = np.random.default_rng(6)
    videos = rng.uniform(0, 255, (3, 4, 24, 24, 3))
    other = rng.uniform(0, 255, (3, 24, 24, 3))
    assert TM.clip_pcc(c.embed, list(videos)) == JM.clip_pcc(
        c.embed, list(videos))
    assert TM.clip_similarity(c.embed, list(videos[:, 0]), list(other)) == \
        JM.clip_similarity(c.embed, list(videos[:, 0]), list(other))
    segs = ["1", "1", "2-3"]
    for scene in (False, True):
        got = TM.remove_overlap(videos, videos + 1, segs, scene)
        want = JM.remove_overlap(videos, videos + 1, segs, scene)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# --- the classifier towers ---------------------------------------------------

def _pair(jmod, tmod, x, seed):
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                              jnp.asarray(x)))["params"]
    params = randomize(shapes, seed)
    load_jax_params(tmod, params)
    return params


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_vit_classifier_matches_jax(pool):
    if pool == "cls":
        jcfg = jvit.ViTConfig.tiny(num_classes=7)
        x = np.random.default_rng(7).standard_normal((2, 3, 32, 32),
                                                     dtype=np.float32)
    else:  # VideoMAE: 4 frames in tubelets of 2
        jcfg = jvit.ViTConfig(image_size=32, patch_size=8, width=32,
                              layers=2, heads=4, num_classes=7,
                              tubelet_size=2, num_frames=4, pool="mean")
        x = np.random.default_rng(8).standard_normal((2, 4, 3, 32, 32),
                                                     dtype=np.float32)
    tcfg = tvit.ViTConfig(*jcfg)
    jm, tm = jvit.ViTClassifier(jcfg), tvit.ViTClassifier(tcfg, device="cpu")
    params = _pair(jm, tm, x, 9)
    want = np.asarray(jax.jit(lambda p, x: jm.apply({"params": p}, x))(
        params, x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (2, 7)
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("quick_gelu", [False, True])
def test_clip_vision_tower_matches_jax(quick_gelu):
    jcfg = jclip.CLIPVisionConfig.tiny()._replace(quick_gelu=quick_gelu)
    tcfg = tclip.CLIPVisionConfig(*jcfg)
    x = np.random.default_rng(10).standard_normal((2, 3, 32, 32),
                                                  dtype=np.float32)
    jm = jclip.CLIPVisionTower(jcfg)
    tm = tclip.CLIPVisionTower(tcfg, device="cpu")
    params = _pair(jm, tm, x, 11)
    want = jax.jit(lambda p, x: jm.apply({"params": p}, x))(params, x)
    with torch.no_grad():
        pooled, tokens = tm(torch.from_numpy(x))
    assert pooled.shape == (2, 24) and tokens.shape == (2, 16, 32)
    assert rel_err(pooled, np.asarray(want[0])) < TOL
    assert rel_err(tokens, np.asarray(want[1])) < TOL


@pytest.mark.parametrize("hw", [180, 256])
def test_preprocess_images_matches_jax(hw):
    x = np.random.default_rng(hw).uniform(size=(2, 3, hw, hw)).astype(
        np.float32)
    got = tclip.preprocess_images(torch.from_numpy(x))
    want = np.asarray(jclip.preprocess_images(jnp.asarray(x)))
    assert rel_err(got, want) < TOL


def test_prep_frames_matches_jax_resize():
    """The runner's processor stand-in: bilinear with antialiasing."""
    x = np.random.default_rng(12).integers(0, 256, (6, 256, 256, 3),
                                           dtype=np.uint8)
    got = TR.prep_frames(x, 224, *TR.IMAGENET_NORM, "cpu")
    y = jnp.moveaxis(jnp.asarray(x, jnp.float32) / 255.0, -1, -3)
    y = jax.image.resize(y, (6, 3, 224, 224), "bilinear")
    m, s = (jnp.asarray(v).reshape(1, 3, 1, 1) for v in TR.IMAGENET_NORM)
    assert rel_err(got, np.asarray((y - m) / s)) < TOL


# --- the importers -----------------------------------------------------------

def test_import_hf_vit_classifier_matches_jax():
    pytest.importorskip("transformers")
    from transformers import ViTConfig, ViTForImageClassification

    torch.manual_seed(0)
    sd = ViTForImageClassification(ViTConfig(
        image_size=32, patch_size=8, hidden_size=24, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48,
        num_labels=5)).state_dict()
    want, want_unused = jti.import_hf_vit_classifier(sd, 2)
    got, unused = tti.import_hf_vit_classifier(sd, 2)
    assert unused == want_unused == []
    assert_trees_equal(got, want)
    tm = tvit.ViTClassifier(tvit.ViTConfig(
        image_size=32, patch_size=8, width=24, layers=2, heads=4,
        num_classes=5, mlp_ratio=2.0), device="cpu")
    assert tti.load_torch_checkpoint(tm, tti.import_hf_vit_classifier, sd,
                                     2) == []


def test_import_videomae_classifier_matches_jax():
    pytest.importorskip("transformers")
    from transformers import VideoMAEConfig, VideoMAEForVideoClassification

    torch.manual_seed(0)
    sd = VideoMAEForVideoClassification(VideoMAEConfig(
        image_size=32, patch_size=8, num_channels=3, num_frames=4,
        tubelet_size=2, hidden_size=24, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=48, num_labels=5,
        use_mean_pooling=True)).state_dict()
    want, want_unused = jti.import_videomae_classifier(sd, 2, 32)
    got, unused = tti.import_videomae_classifier(sd, 2, 32)
    assert unused == want_unused
    assert_trees_equal(got, want)
    np.testing.assert_array_equal(tti._sinusoid_table(588, 768),
                                  jti._sinusoid_table(588, 768))


def test_import_hf_clip_vision_matches_jax():
    pytest.importorskip("transformers")
    from transformers import CLIPVisionConfig, CLIPVisionModelWithProjection

    torch.manual_seed(0)
    sd = CLIPVisionModelWithProjection(CLIPVisionConfig(
        image_size=32, patch_size=8, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        projection_dim=24)).state_dict()
    want, want_unused = jti.import_hf_clip_vision(sd, 2)
    got, unused = tti.import_hf_clip_vision(sd, 2)
    assert unused == want_unused
    assert_trees_equal(got, want)
    tm = tclip.CLIPVisionTower(tclip.CLIPVisionConfig.tiny(), device="cpu")
    tti.load_torch_checkpoint(tm, tti.import_hf_clip_vision, sd, 2,
                              allow_unused=True)


# --- the runner --------------------------------------------------------------

def write_gif_dir(path, n_clips=3, f=4, hw=24, seed=13):
    """GIFs as stage 5 writes them: ground truth beside the prediction."""
    rng = np.random.default_rng(seed)
    for i in range(n_clips):
        gt = rng.uniform(size=(1, f, 3, hw, hw))
        pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1)
        tio.save_video_grid(np.concatenate([gt, pred], -1),
                            str(path / tio.gif_artifact_name(i, f"clip {i}")))


def test_run_metrics_matches_jax(tmp_path):
    write_gif_dir(tmp_path)
    c = Classifiers(14, 24, 4)
    got = TR.run_metrics(str(tmp_path), c.for_port(), num_trials=20,
                         verbose=False, device="cpu")
    want = JR.run_metrics(str(tmp_path), c.for_jax(), num_trials=20,
                          verbose=False)
    assert sorted(got) == sorted(want) == sorted(
        ["clip_pcc", "clip_pcc_std", "video_2way", "video_50way", "ssim",
         "psnr", "frame_2way", "frame_50way"])
    for k in ("clip_pcc", "clip_pcc_std", "video_2way", "video_50way",
              "frame_2way", "frame_50way"):
        assert got[k] == want[k], k
    for k in ("ssim", "psnr"):
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    gts, preds = TR.load_gif_dir(str(tmp_path))
    jgts, jpreds = JR.load_gif_dir(str(tmp_path))
    np.testing.assert_array_equal(gts, jgts)
    np.testing.assert_array_equal(preds, jpreds)
    assert jio.load_gif(str(next(tmp_path.iterdir()))).shape == (4, 24, 48, 3)


def test_build_metric_classifiers_without_weights(tmp_path):
    assert TR.build_metric_classifiers(str(tmp_path), device="cpu") is None
    assert JR.build_metric_classifiers(str(tmp_path)) is None


# --- chip_smoke.py's HF exports ----------------------------------------------

@pytest.mark.parametrize("tower", ["vit", "videomae", "clip"])
def test_chip_smoke_hf_exports_round_trip(tower):
    """`chip_smoke.py` hands the card's classifiers to `eval` as HF state
    dicts; its exporters invert the importers: every parameter comes back
    equal (VideoMAE's key bias, which HF does not store, as zero)."""
    import sys
    from pathlib import Path

    from neurons_tpu_torch.utils.synth_init import synth_params_

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke

    if tower == "clip":
        def build():
            return tclip.CLIPVisionTower(tclip.CLIPVisionConfig.tiny(),
                                         device="cpu")
        export, imp, args = (chip_smoke.hf_clip_state_dict,
                             tti.import_hf_clip_vision, (2,))
    elif tower == "vit":
        def build():
            return tvit.ViTClassifier(tvit.ViTConfig.tiny(7), device="cpu")
        export, imp, args = (chip_smoke.hf_vit_state_dict,
                             tti.import_hf_vit_classifier, (2,))
    else:
        cfg = tvit.ViTConfig(image_size=32, patch_size=8, width=32, layers=2,
                             heads=4, num_classes=7, tubelet_size=2,
                             num_frames=4, pool="mean")

        def build():
            return tvit.ViTClassifier(cfg, device="cpu")
        export, imp, args = (
            lambda m: chip_smoke.hf_vit_state_dict(m, "videomae"),
            tti.import_videomae_classifier, (2, cfg.num_tokens()))
    src = synth_params_(build(), 3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name, p in src.named_parameters():
            if not name.endswith("k.bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    dst = build()
    assert tti.load_torch_checkpoint(dst, imp, export(src), *args) == []
    for (name, a), (_, b) in zip(src.named_parameters(),
                                 dst.named_parameters()):
        if name != "pos_embed" or tower != "videomae":  # recomputed
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
