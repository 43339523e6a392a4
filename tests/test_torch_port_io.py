"""The port's artifact and GIF I/O and its `caption` / `eval` subcommands
against the JAX package's, on the CPU: a directory written by either
package loads in the other, the native GIF codec gives the same bytes, and
the two CLIs agree on what they write."""

import json
import os

import numpy as np
import pytest
import torch

from neurons_tpu import cli as jcli
from neurons_tpu import native_io as jnative
from neurons_tpu.pipelines import io as jio
from neurons_tpu_torch import cli as tcli
from neurons_tpu_torch import native_io as tnative
from neurons_tpu_torch.pipelines import io as tio

SUBJ = 2
CAPTIONS = ["a dog runs", "two  people / talk", ""]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stage3_arrays(seed=0, n=3):
    rng = np.random.default_rng(seed)
    return dict(all_recons=rng.uniform(size=(n, 3, 32, 32)).astype(np.float32),
                all_gts=rng.uniform(size=(n, 3, 24, 24)).astype(np.float32),
                blurry_videos=rng.uniform(size=(n, 6, 3, 16, 16)).astype(
                    np.float32))


@pytest.mark.parametrize("writer,reader", [(tio, jio), (jio, tio)],
                         ids=["port_to_jax", "jax_to_port"])
def test_stage3_and_caption_artifacts_interoperate(tmp_path, writer, reader):
    arrs = stage3_arrays()
    writer.save_stage3_artifacts(str(tmp_path), SUBJ, captions=CAPTIONS,
                                 **arrs)
    got = reader.load_stage3_artifacts(str(tmp_path), SUBJ)
    for k, v in arrs.items():
        np.testing.assert_array_equal(got[k], v)
    assert got["captions"] == CAPTIONS
    blip = ["caption one", "caption two", "caption three"]
    writer.save_caption_artifact(str(tmp_path), blip)
    assert reader.load_captions(str(tmp_path)) == blip
    assert reader.load_captions(str(tmp_path), "self") == CAPTIONS
    assert reader.load_stage3_artifacts(str(tmp_path), SUBJ,
                                        "blip")["captions"] == blip


def test_artifact_files_are_byte_equal(tmp_path):
    arrs = stage3_arrays(1)
    for pkg, d in ((tio, tmp_path / "port"), (jio, tmp_path / "jax")):
        pkg.save_stage3_artifacts(str(d), SUBJ, captions=CAPTIONS, **arrs)
        pkg.save_caption_artifact(str(d), CAPTIONS[::-1])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_legacy_npz_and_flat_blurry_layouts(tmp_path):
    arrs = stage3_arrays(2)
    np.savez(tmp_path / f"subj{SUBJ:02d}_all_recons.npz",
             all_recons=arrs["all_recons"], all_gts=arrs["all_gts"])
    np.savez(tmp_path / "recon_videos.npz",
             videos=arrs["blurry_videos"].reshape(-1, 3, 16, 16))
    (tmp_path / "pred_test_caption_self.txt").write_text("\n".join(CAPTIONS))
    got = tio.load_stage3_artifacts(str(tmp_path), SUBJ)
    want = jio.load_stage3_artifacts(str(tmp_path), SUBJ)
    for k in ("all_recons", "all_gts", "blurry_videos"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["blurry_videos"].shape == (3, 6, 3, 16, 16)
    # the .txt sidecar's lines (a trailing empty caption is no line)
    assert got["captions"] == want["captions"] == CAPTIONS[:2]


@pytest.mark.parametrize("prompt", ["a cat", "a  cat / sits", "", "x/y z",
                                    "ids:2,5,99"])
def test_gif_artifact_name(prompt):
    assert tio.gif_artifact_name(7, prompt) == jio.gif_artifact_name(7, prompt)


def test_native_codec_matches_jax_and_builds_into_the_package():
    assert tnative.available()
    lib = tnative.library_path()
    assert lib.exists() and lib.parent == tnative.BUILD_DIR
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (6, 20, 36, 3), dtype=np.uint8)
    data = tnative.encode_gif(frames, delay_ms=125)
    assert data == jnative.encode_gif(frames, delay_ms=125)
    np.testing.assert_array_equal(tnative.decode_gif(data),
                                  jnative.decode_gif(data))
    # at most 256 colours: the codec is lossless
    few = np.repeat(frames[..., :1] // 64 * 64, 3, axis=-1)
    np.testing.assert_array_equal(tnative.decode_gif(tnative.encode_gif(few)),
                                  few)
    assert tnative.decode_gif(b"not a gif") is None


def test_parallel_read(tmp_path):
    path = tmp_path / "blob"
    payload = np.random.default_rng(4).integers(0, 256, 5000, dtype=np.uint8)
    path.write_bytes(payload.tobytes())
    bufs = tnative.parallel_read([str(path)] * 3, [0, 100, 4000],
                                 [10, 900, 1000], threads=2)
    for buf, (o, s) in zip(bufs, [(0, 10), (100, 900), (4000, 1000)]):
        np.testing.assert_array_equal(buf, payload[o:o + s])
    assert tnative.parallel_read([str(tmp_path / "missing")], [0], [1]) is None


def test_video_grid_gifs_are_byte_equal(tmp_path):
    rng = np.random.default_rng(5)
    videos = rng.uniform(-0.1, 1.1, (2, 4, 3, 16, 16))
    for pkg in (tio, jio):
        pkg.save_video_grid(videos, str(tmp_path / f"{pkg.__name__}.gif"))
        pkg.save_video_grid(videos.transpose(0, 2, 1, 3, 4),
                            str(tmp_path / f"{pkg.__name__}_cf.gif"))
    for suffix in ("", "_cf"):
        port = (tmp_path / f"{tio.__name__}{suffix}.gif").read_bytes()
        assert port == (tmp_path / f"{jio.__name__}{suffix}.gif").read_bytes()
    path = str(tmp_path / f"{tio.__name__}.gif")
    gif = tio.load_gif(path)
    assert gif.shape == (4, 16, 32, 3)
    np.testing.assert_array_equal(gif, jio.load_gif(path))
    gt, pred = tio.split_gt_pred(gif)
    assert gt.shape == pred.shape == (4, 16, 16, 3)


def test_load_gif_falls_back_to_imageio(tmp_path, monkeypatch):
    pytest.importorskip("imageio")
    path = str(tmp_path / "clip.gif")
    tio.save_video_grid(np.random.default_rng(6).uniform(size=(1, 3, 3, 8, 8)),
                        path)
    want = tio.load_gif(path)
    monkeypatch.setattr(tnative, "decode_gif", lambda data: None)
    np.testing.assert_array_equal(tio.load_gif(path), want)


def test_caption_cli_writes_the_jax_dialect(tmp_path):
    """`caption --tiny --synthetic --platform cpu` over a stage-3 directory
    the JAX package wrote: one raw-id caption per keyframe, 8 tokens from
    BOS, read back by the JAX loader."""
    arrs = stage3_arrays(7, n=10)
    st3 = jio.stage3_dir(str(tmp_path), "t", SUBJ, False)
    jio.save_stage3_artifacts(st3, SUBJ, captions=["self"] * 10, **arrs)
    tcli.main(["caption", "--tiny", "--synthetic", "--platform", "cpu",
               "--exp_dir", str(tmp_path), "--exp", "t", "--subj",
               str(SUBJ), "--seed", "3"])
    caps = jio.load_captions(st3, "blip")
    assert len(caps) == 10
    for cap in caps:
        ids = [int(i) for i in cap.removeprefix("ids:").split(",")]
        assert cap.startswith("ids:") and len(ids) == 8 and ids[0] == 2
        assert all(0 <= i < 100 for i in ids)
    assert jio.load_captions(st3, "self") == ["self"] * 10
    assert tcli._STAGE_STATS["4"]["batch"] == 8


def test_eval_cli_matches_jax_eval(tmp_path):
    vdir = jio.video_dir(str(tmp_path), "t", SUBJ, "motion")
    rng = np.random.default_rng(8)
    for i in range(3):
        gt = rng.uniform(size=(1, 6, 3, 24, 24))
        pred = np.clip(gt + rng.normal(0, 0.15, gt.shape), 0, 1)
        tio.save_video_grid(np.concatenate([gt, pred], -1),
                            os.path.join(vdir, tio.gif_artifact_name(i, "p")))
    argv = ["eval", "--platform", "cpu", "--exp_dir", str(tmp_path), "--exp",
            "t", "--subj", str(SUBJ), "--weights_dir", str(tmp_path / "none")]
    out = os.path.join(jio.exp_dir(str(tmp_path), "t", SUBJ),
                       "metrics_motion.json")
    tcli.main(argv)
    with open(out) as f:
        got = json.load(f)
    os.remove(out)
    jcli.main(argv)
    with open(out) as f:
        want = json.load(f)
    assert sorted(got) == sorted(want) == ["psnr", "ssim"]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k


def test_cli_refuses_a_missing_stage3_dir_without_synthetic(tmp_path):
    with pytest.raises(FileNotFoundError):
        tcli.main(["caption", "--tiny", "--platform", "cpu", "--exp_dir",
                   str(tmp_path)])
