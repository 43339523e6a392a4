"""Inference serving for the voxel -> video pipeline, over HTTP.

Counterpart of neurons_tpu/serving.py: a batching scheduler that coalesces
concurrent requests into batches of one fixed size (requests are
zero-padded up to it and split on reply), one worker thread that owns the
device, and a stdlib-only HTTP surface.

Endpoints:
  GET  /healthz      -> {"status": "ok", platform, device, n_voxels,
                        batch_size, served_clips}
  GET  /stats        -> latency percentiles and mean batch occupancy
  POST /reconstruct  -> body: one .npy of voxels, [n_voxels] or
                        [k, n_voxels] (k <= batch_size).
                        ?format=npy (default) returns an .npy video
                        [k, F, 3, H, W] in [0, 1]; ?format=gif a GIF
                        (the clips side by side) from the native codec
                        (native/neurons_io.cpp), imageio without it.
Status codes: 400 for a bad shape or a full queue, 504 when the pipeline
times out, 500 for a pipeline error (the worker keeps serving), 404 for
an unknown path.

The pipeline is the one bench_torch.py times (stage 3 then stage 5,
`pipelines/e2e.py`), on the models `bench_torch.build` makes:

    python -m neurons_tpu_torch.serving --tiny --platform cpu

serves the tiny configuration on the CPU; without `--platform cpu` it runs
on the card. The pipeline runs on the scheduler's worker thread: grad mode
and the current CUDA device are per thread, so it enters
`torch.inference_mode()` and the device itself. Unlike the JAX package,
`health()` reports the device the pipeline was built on (torch's device
type and `torch.cuda.get_device_name`), not the first device the
framework sees.
"""

from __future__ import annotations

import contextlib
import io as _io
import json
import os
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

Pipeline = Callable[[np.ndarray, int], np.ndarray]


@dataclass
class ServerConfig:
    host: str = "127.0.0.1"
    port: int = 8000
    # the pipeline's batch: requests are coalesced up to this many clips,
    # then zero-padded to exactly this shape
    batch_size: int = 1
    # how long the scheduler waits for more requests to fill a batch after
    # the first arrives (0 = dispatch immediately)
    max_wait_ms: float = 5.0
    # reject requests when this many clips are already queued
    max_queue: int = 64


@dataclass
class _Request:
    voxels: np.ndarray          # [k, n_voxels]
    enqueued: float
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[str] = None


class BatchingScheduler:
    """Coalesces requests into fixed-size padded batches for a pipeline
    `fn(voxels [B, n_voxels] f32, seed int) -> video [B, F, 3, H, W] f32 in
    [0, 1]` and runs them on one worker thread; batch i gets seed i."""

    def __init__(self, pipeline: Pipeline, n_voxels: int, cfg: ServerConfig):
        self.pipeline = pipeline
        self.n_voxels = n_voxels
        self.cfg = cfg
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._queued_clips = 0
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # bounded: percentiles are over the most recent window
        self._latencies_ms: "deque[float]" = deque(maxlen=10000)
        self._batch_sizes: "deque[int]" = deque(maxlen=10000)
        self.served = 0
        self._seed = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="neurons-serve-worker")
        self._worker.start()

    # ---- client side ----
    def submit(self, voxels: np.ndarray,
               timeout: Optional[float] = None) -> np.ndarray:
        voxels = np.asarray(voxels, np.float32)
        if voxels.ndim == 1:
            voxels = voxels[None]
        if voxels.ndim != 2 or voxels.shape[1] != self.n_voxels:
            raise ValueError(
                f"expected voxels [k, {self.n_voxels}], got {voxels.shape}")
        if voxels.shape[0] > self.cfg.batch_size:
            raise ValueError(
                f"request of {voxels.shape[0]} clips exceeds the batch size "
                f"{self.cfg.batch_size}; split the request")
        with self._lock:
            if self._queued_clips + voxels.shape[0] > self.cfg.max_queue:
                raise OverflowError("queue full")
            self._queued_clips += voxels.shape[0]
        req = _Request(voxels=voxels, enqueued=time.perf_counter())
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("pipeline did not finish in time")
        if req.error is not None:
            raise RuntimeError(req.error)
        return req.result

    # ---- worker side ----
    def _take_batch(self) -> Optional[list]:
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return None
        batch = [first]
        clips = first.voxels.shape[0]
        deadline = time.perf_counter() + self.cfg.max_wait_ms / 1e3
        while clips < self.cfg.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if clips + nxt.voxels.shape[0] > self.cfg.batch_size:
                # back into the queue for the next batch
                self._q.put(nxt)
                break
            batch.append(nxt)
            clips += nxt.voxels.shape[0]
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._take_batch()
            if batch is None:
                continue
            clips = sum(r.voxels.shape[0] for r in batch)
            with self._lock:
                self._queued_clips -= clips
            voxels = np.concatenate([r.voxels for r in batch], axis=0)
            pad = self.cfg.batch_size - voxels.shape[0]
            if pad:
                voxels = np.concatenate(
                    [voxels, np.zeros((pad, self.n_voxels), np.float32)])
            self._seed += 1
            try:
                video = np.asarray(self.pipeline(voxels, self._seed))
            except Exception as e:  # noqa: BLE001 - reported to every waiter
                for r in batch:
                    r.error = f"{type(e).__name__}: {e}"
                    r.done.set()
                continue
            now = time.perf_counter()
            # one lock for the batch's stats, so /stats is consistent
            with self._lock:
                for r in batch:
                    self._latencies_ms.append((now - r.enqueued) * 1e3)
                self._batch_sizes.append(clips)
                self.served += clips
            off = 0
            for r in batch:
                k = r.voxels.shape[0]
                r.result = video[off:off + k]
                off += k
                r.done.set()

    def stats(self) -> dict:
        with self._lock:  # the deques must not be read during appends
            lat, bs = sorted(self._latencies_ms), list(self._batch_sizes)
            served, queued = self.served, self._queued_clips

        def pct(p):
            return round(lat[min(len(lat) - 1,
                                 int(p / 100 * len(lat)))], 2) if lat else None

        return {
            "served_clips": served,
            "batches": len(bs),
            "mean_batch_occupancy": round(sum(bs) / len(bs), 3) if bs
            else None,
            "latency_ms_p50": pct(50),
            "latency_ms_p95": pct(95),
            "queued_clips": queued,
        }

    def served_clips(self) -> int:
        with self._lock:
            return self.served

    def close(self):
        self._stop.set()
        self._worker.join(timeout=5)


def _encode_gif(video: np.ndarray, fps: int = 8) -> bytes:
    """video [k, F, 3, H, W] in [0, 1] -> GIF bytes, the clips side by
    side."""
    from neurons_tpu_torch import native_io

    v = np.clip(np.asarray(video), 0.0, 1.0)
    frames = []
    for f in range(v.shape[1]):
        row = np.concatenate(list(v[:, f]), axis=-1)       # join on W
        frames.append((row.transpose(1, 2, 0) * 255).astype(np.uint8))
    frames = np.stack(frames)
    data = native_io.encode_gif(frames, delay_ms=int(1000 / fps))
    if data is not None:
        return data
    import imageio
    buf = _io.BytesIO()
    imageio.mimsave(buf, list(frames), format="gif", duration=1000 / fps,
                    loop=0)
    return buf.getvalue()


class InferenceServer:
    """HTTP front end over a BatchingScheduler. `device` is the device the
    pipeline runs on, reported by /healthz."""

    def __init__(self, pipeline: Pipeline, n_voxels: int,
                 cfg: ServerConfig = ServerConfig(), device=None):
        self.cfg = cfg
        self.device = None if device is None else torch.device(device)
        self.scheduler = BatchingScheduler(pipeline, n_voxels, cfg)
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no line per request
                pass

            def _send(self, code, body: bytes, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _json(self, code, obj):
                self._send(code, json.dumps(obj).encode())

            def do_GET(self):
                if self.path.startswith("/healthz"):
                    self._json(200, server.health())
                elif self.path.startswith("/stats"):
                    self._json(200, server.scheduler.stats())
                else:
                    self._json(404, {"error": "unknown path"})

            def do_POST(self):
                if not self.path.startswith("/reconstruct"):
                    self._json(404, {"error": "unknown path"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    arr = np.load(_io.BytesIO(self.rfile.read(n)),
                                  allow_pickle=False)
                    video = server.scheduler.submit(arr)
                except (ValueError, OverflowError) as e:
                    self._json(400, {"error": str(e)})
                    return
                except TimeoutError as e:
                    self._json(504, {"error": str(e)})
                    return
                except Exception as e:  # noqa: BLE001 - the server keeps serving
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                if "format=gif" in (self.path.split("?", 1) + [""])[1]:
                    self._send(200, _encode_gif(video), "image/gif")
                else:
                    buf = _io.BytesIO()
                    np.save(buf, video)
                    self._send(200, buf.getvalue(),
                               "application/octet-stream")

        self._http = ThreadingHTTPServer((cfg.host, cfg.port), Handler)
        self.port = self._http.server_address[1]  # resolved when port=0
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        daemon=True, name="neurons-serve")

    def health(self) -> dict:
        dev = self.device
        if dev is None:
            platform, name = "unknown", "unknown"
        elif dev.type == "cuda":
            platform, name = "cuda", torch.cuda.get_device_name(dev)
        else:
            platform, name = dev.type, dev.type
        return {"status": "ok", "platform": platform, "device": name,
                "n_voxels": self.scheduler.n_voxels,
                "batch_size": self.cfg.batch_size,
                "served_clips": self.scheduler.served_clips()}

    def start(self):
        self._thread.start()
        return self

    def serve_forever(self):
        self._thread.start()
        self._thread.join()

    def close(self):
        self._http.shutdown()
        self._http.server_close()
        self.scheduler.close()


def clip_pipeline(models, pcfg, shapes, class_text_embeds, device,
                  sampler_opts: Optional[dict] = None,
                  video_opts: Optional[dict] = None) -> Pipeline:
    """The pipeline function over built models (`bench_torch.build`'s
    (dec, unet, vae, text, unet3d, cn), its config and (keyframe latent
    side, artifact side, caption tokens)): each batch draws from a
    `torch.Generator` on `device` seeded with the batch's seed and runs
    `e2e.run_stage3` then `run_stage5`, as `bench_torch.run_once` does;
    the video comes back on the host, clipped to [0, 1]."""
    from neurons_tpu_torch import resolve_device
    from neurons_tpu_torch.pipelines import e2e

    dev = resolve_device(device)
    dec, unet, vae, text, unet3d, cn = models
    latent_hw, artifact_hw, caption_len = shapes

    def pipeline(voxels: np.ndarray, seed: int) -> np.ndarray:
        scope = (torch.cuda.device(dev) if dev.type == "cuda"
                 else contextlib.nullcontext())
        with torch.inference_mode(), scope:
            g = torch.Generator(dev).manual_seed(seed)
            vox = torch.as_tensor(np.asarray(voxels, np.float32),
                                  device=dev)[:, None, :]  # the repeat axis
            art = e2e.run_stage3(dec, unet, vae, vox, class_text_embeds,
                                 pcfg.sampler, latent_hw=latent_hw,
                                 artifact_hw=artifact_hw,
                                 caption_len=caption_len, generator=g,
                                 sampler_opts=sampler_opts, device=dev)
            vid = e2e.run_stage5(text, unet3d, cn, vae, art, pcfg.sampler,
                                 generator=g, device=dev,
                                 **(video_opts or {}))
            return vid.video.float().clamp(0.0, 1.0).cpu().numpy()

    return pipeline


def build_bench_pipeline(batch_size: int, device=None):
    """The pipeline bench_torch.py measures, built by `bench_torch.build`
    (seeded random weights; BENCH_TINY and the fast-path knobs honoured),
    on `device` (default: BENCH_PLATFORM, else the card), warmed up once at
    `batch_size`. Returns (pipeline, n_voxels)."""
    import sys

    from neurons_tpu_torch import resolve_device

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import bench_torch

    dev = resolve_device(device or os.environ.get("BENCH_PLATFORM", "cuda"))
    tiny = os.environ.get("BENCH_TINY") == "1"
    models, pcfg, shapes = bench_torch.build(tiny, dev)
    d = pcfg.decoupler
    classes = torch.randn((d.num_classes, d.clip_txt_emb_dim),
                          generator=torch.Generator(dev).manual_seed(7),
                          device=dev)
    s3_opts, s5_opts = bench_torch.fast_knobs()
    pipeline = clip_pipeline(models, pcfg, shapes, classes, dev, s3_opts,
                             s5_opts)
    n_vox = pcfg.brain.voxel_counts[0]
    pipeline(np.zeros((batch_size, n_vox), np.float32), 0)  # warm-up
    return pipeline, n_vox


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Serve the voxel -> video pipeline over HTTP")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny random-weight pipeline (smoke)")
    ap.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="device the pipeline runs on (default: the card)")
    args = ap.parse_args(argv)
    if args.tiny:
        os.environ["BENCH_TINY"] = "1"
    pipeline, n_vox = build_bench_pipeline(args.batch_size, args.platform)
    cfg = ServerConfig(host=args.host, port=args.port,
                       batch_size=args.batch_size,
                       max_wait_ms=args.max_wait_ms)
    srv = InferenceServer(pipeline, n_vox, cfg, device=args.platform)
    print(f"serving on http://{args.host}:{srv.port}  "
          f"(batch {cfg.batch_size}, n_voxels {n_vox})", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
