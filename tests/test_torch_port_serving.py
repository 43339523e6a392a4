"""The port's server (`neurons_tpu_torch/serving.py`) against the JAX
package's (`neurons_tpu/serving.py`), on the CPU.

Every case of tests/test_serving.py runs on both packages' classes with the
same fake pipeline (parametrised over the package: the assertions are the
same), plus: a pipeline error answers 500 and the worker serves the next
request, `max_queue` refuses with 400, the stats deques are bounded, both
packages' GIFs of one video are byte-equal (the native codec), and the
tiny bench pipeline (`build_bench_pipeline(2, device="cpu")` under
BENCH_TINY=1) served over HTTP: a single and a 2-clip request answer
[k, F, 3, H, W] in [0, 1], each clip equal to the direct pipeline call on
the same padded batch and seed, and a pipeline call on the scheduler's
worker thread equal to one on the main thread.
"""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from neurons_tpu import serving as jserving
from neurons_tpu import native_io as jnative
from neurons_tpu_torch import native_io as tnative
from neurons_tpu_torch import serving as tserving
from torch_port_utils import ensure_jax_native_io

N_VOX = 16
F, H, W = 2, 4, 4
PACKAGES = {"jax": jserving, "port": tserving}


@pytest.fixture(autouse=True, scope="module")
def _jax_native_codec():
    """The JAX package's native codec whole before this module's tests
    reach it (`torch_port_utils.ensure_jax_native_io`)."""
    ensure_jax_native_io()


@pytest.fixture(params=sorted(PACKAGES))
def srvmod(request):
    return PACKAGES[request.param]


class FakePipeline:
    """video[b, ...] = mean(voxels[b]) everywhere: per-request routing
    through a shared batch shows in the values."""

    def __init__(self):
        self.calls = []

    def __call__(self, voxels, seed):
        self.calls.append(np.array(voxels))
        vid = np.ones((voxels.shape[0], F, 3, H, W), np.float32)
        return vid * voxels.mean(axis=1)[:, None, None, None, None]


def make(mod, batch_size=1, max_wait_ms=0.0, max_queue=64):
    fp = FakePipeline()
    sched = mod.BatchingScheduler(fp, N_VOX, mod.ServerConfig(
        batch_size=batch_size, max_wait_ms=max_wait_ms,
        max_queue=max_queue))
    return fp, sched


# --- the scheduler -------------------------------------------------------------

def test_single_request_roundtrip(srvmod):
    fp, sched = make(srvmod)
    try:
        out = sched.submit(np.full((N_VOX,), 0.25, np.float32), timeout=10)
        assert out.shape == (1, F, 3, H, W)
        np.testing.assert_allclose(out, 0.25, rtol=1e-6)
        assert sched.served == 1
    finally:
        sched.close()


def test_padding_is_discarded(srvmod):
    fp, sched = make(srvmod, batch_size=4)
    try:
        out = sched.submit(np.full((2, N_VOX), 0.5, np.float32), timeout=10)
        assert out.shape == (2, F, 3, H, W)
        assert fp.calls[0].shape == (4, N_VOX)   # the full padded batch
        np.testing.assert_allclose(fp.calls[0][2:], 0.0)
    finally:
        sched.close()


def test_concurrent_requests_coalesce(srvmod):
    fp, sched = make(srvmod, batch_size=4, max_wait_ms=500.0)
    try:
        results = {}

        def post(tag, value):
            results[tag] = sched.submit(
                np.full((1, N_VOX), value, np.float32), timeout=20)

        threads = [threading.Thread(target=post, args=("a", 0.25)),
                   threading.Thread(target=post, args=("b", 0.75))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        assert len(fp.calls) == 1, "requests were not coalesced"
        np.testing.assert_allclose(results["a"], 0.25, rtol=1e-6)
        np.testing.assert_allclose(results["b"], 0.75, rtol=1e-6)
    finally:
        sched.close()


def test_bad_shapes_rejected(srvmod):
    fp, sched = make(srvmod, batch_size=2)
    try:
        with pytest.raises(ValueError):
            sched.submit(np.zeros((N_VOX + 1,), np.float32))
        with pytest.raises(ValueError):
            sched.submit(np.zeros((3, N_VOX), np.float32))  # > batch
    finally:
        sched.close()


def test_pipeline_error_propagates(srvmod):
    def boom(voxels, seed):
        raise RuntimeError("device on fire")

    sched = srvmod.BatchingScheduler(boom, N_VOX, srvmod.ServerConfig())
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            sched.submit(np.zeros((N_VOX,), np.float32), timeout=10)
    finally:
        sched.close()


def test_stats(srvmod):
    fp, sched = make(srvmod)
    try:
        sched.submit(np.zeros((N_VOX,), np.float32), timeout=10)
        s = sched.stats()
        assert s["served_clips"] == 1 and s["batches"] == 1
        assert s["latency_ms_p50"] is not None
    finally:
        sched.close()


def _wait(cond, seconds=20.0):
    stop = threading.Event()
    for _ in range(int(seconds / 0.01)):
        if cond():
            return True
        stop.wait(0.01)
    return False


def test_queue_full_is_refused(srvmod):
    started, release = threading.Event(), threading.Event()

    def slow(voxels, seed):
        started.set()
        release.wait(20)
        return np.zeros((voxels.shape[0], F, 3, H, W), np.float32)

    sched = srvmod.BatchingScheduler(slow, N_VOX, srvmod.ServerConfig(
        batch_size=1, max_wait_ms=0.0, max_queue=2))
    one = np.zeros((1, N_VOX), np.float32)
    clients = [threading.Thread(target=sched.submit, args=(one, 30))
               for _ in range(3)]
    try:
        clients[0].start()          # taken by the worker, which blocks
        assert started.wait(20)
        for c in clients[1:]:       # two queued clips: the limit
            c.start()
        assert _wait(lambda: sched.stats()["queued_clips"] == 2)
        with pytest.raises(OverflowError):
            sched.submit(one, timeout=1)
    finally:
        release.set()
        for c in clients:
            c.join(timeout=30)
        sched.close()
    assert not any(c.is_alive() for c in clients)
    assert sched.served_clips() == 3


def test_stats_deques_are_bounded(srvmod):
    fp, sched = make(srvmod)
    try:
        assert sched._latencies_ms.maxlen == 10000
        assert sched._batch_sizes.maxlen == 10000
    finally:
        sched.close()


def test_gif_bytes_equal_across_packages():
    # both packages on their native codec: a comparison against the JAX
    # package's imageio fallback would say nothing of the port's bytes
    why = ensure_jax_native_io()
    assert why is None, f"the JAX package's native GIF codec: {why}"
    assert jnative.available(), (
        "neurons_tpu.native_io did not load native/libneurons_io.so")
    assert tnative.available(), (
        "neurons_tpu_torch.native_io did not build or load its codec")
    video = np.random.default_rng(3).uniform(size=(2, 3, 3, 8, 8)).astype(
        np.float32)
    assert tserving._encode_gif(video) == jserving._encode_gif(video)


# --- HTTP ----------------------------------------------------------------------

@pytest.fixture()
def server(srvmod):
    srv = srvmod.InferenceServer(FakePipeline(), N_VOX, srvmod.ServerConfig(
        port=0, batch_size=2))
    srv.start()
    yield srv
    srv.close()


def _post(port, arr, path="/reconstruct"):
    buf = io.BytesIO()
    np.save(buf, arr)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=buf.getvalue())
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp, body


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp, body


def test_healthz_and_stats(server):
    resp, body = _get(server.port, "/healthz")
    health = json.loads(body)
    assert health["status"] == "ok"
    assert health["n_voxels"] == N_VOX
    resp, body = _get(server.port, "/stats")
    assert "served_clips" in json.loads(body)


def test_reconstruct_npy_roundtrip(server):
    resp, body = _post(server.port, np.full((N_VOX,), 0.5, np.float32))
    assert resp.status == 200
    video = np.load(io.BytesIO(body))
    assert video.shape == (1, F, 3, H, W)
    np.testing.assert_allclose(video, 0.5, rtol=1e-6)


def test_reconstruct_gif(server):
    resp, body = _post(server.port, np.full((N_VOX,), 0.5, np.float32),
                       path="/reconstruct?format=gif")
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "image/gif"
    assert body[:4] == b"GIF8"


def test_bad_request_is_400(server):
    resp, body = _post(server.port, np.zeros((N_VOX + 3,), np.float32))
    assert resp.status == 400
    assert "expected voxels" in json.loads(body)["error"]


def test_unknown_path_404(server):
    assert _get(server.port, "/nope")[0].status == 404


def test_pipeline_error_is_500_and_serving_continues(srvmod):
    calls = []

    def flaky(voxels, seed):
        calls.append(seed)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return np.zeros((voxels.shape[0], F, 3, H, W), np.float32)

    srv = srvmod.InferenceServer(flaky, N_VOX, srvmod.ServerConfig(
        port=0, batch_size=1)).start()
    try:
        resp, body = _post(srv.port, np.zeros((N_VOX,), np.float32))
        assert resp.status == 500
        assert "transient" in json.loads(body)["error"]
        resp, body = _post(srv.port, np.zeros((N_VOX,), np.float32))
        assert resp.status == 200
        assert calls == [1, 2]  # batch i runs with seed i
    finally:
        srv.close()


def test_port_health_names_the_device():
    srv = tserving.InferenceServer(FakePipeline(), N_VOX,
                                   tserving.ServerConfig(port=0),
                                   device="cpu").start()
    try:
        h = srv.health()
        assert (h["platform"], h["device"]) == ("cpu", "cpu")
    finally:
        srv.close()


# --- the tiny bench pipeline, served ---------------------------------------------

def test_tiny_bench_pipeline_served_over_http(monkeypatch):
    monkeypatch.setenv("BENCH_TINY", "1")
    for knob in ("BENCH_TGATE", "BENCH_TGATE_VIDEO", "BENCH_TGATE_PAB",
                 "BENCH_PAB", "BENCH_PAB_KF", "BENCH_PAB_RANGE",
                 "BENCH_ENC_REUSE", "BENCH_DEEPCACHE"):
        monkeypatch.delenv(knob, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pipeline, n_vox = tserving.build_bench_pipeline(2, device="cpu")
        seen = []

        def recorded(voxels, seed):
            out = pipeline(voxels, seed)
            seen.append((voxels.copy(), seed, out))
            return out

        srv = tserving.InferenceServer(recorded, n_vox, tserving.ServerConfig(
            port=0, batch_size=2, max_wait_ms=0.0), device="cpu").start()
        try:
            rng = np.random.default_rng(5)
            single = rng.standard_normal((n_vox,)).astype(np.float32)
            pair = rng.standard_normal((2, n_vox)).astype(np.float32)
            videos = []
            for arr in (single, pair):
                resp, body = _post(srv.port, arr)
                assert resp.status == 200
                videos.append(np.load(io.BytesIO(body)))
            assert json.loads(_get(srv.port, "/stats")[1])["batches"] == 2
        finally:
            srv.close()
        for (voxels, seed, out), video, k in zip(seen, videos, (1, 2)):
            assert video.shape[:3] == (k, 4, 3) and video.ndim == 5
            assert np.isfinite(video).all()
            assert video.min() >= 0.0 and video.max() <= 1.0
            # the served clips are the direct call's on the padded batch
            np.testing.assert_array_equal(video, pipeline(voxels, seed)[:k])
        np.testing.assert_array_equal(seen[0][0][1:], 0.0)  # the zero pad
        # the pipeline on another thread (the worker's) gives the same bits
        box = {}
        th = threading.Thread(target=lambda: box.setdefault(
            "out", pipeline(seen[1][0], 9)))
        th.start()
        th.join(timeout=120)
        assert not th.is_alive()
        np.testing.assert_array_equal(box["out"], pipeline(seen[1][0], 9))
    finally:
        torch.set_num_threads(n)
