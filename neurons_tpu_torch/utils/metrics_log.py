"""Experiment metrics logging.

Counterpart of neurons_tpu/utils/metrics_log.py: one JSONL line per
`log_metrics` call in `<log_dir>/metrics.jsonl`, image panels as PNGs under
`<log_dir>/images/` (an `.npy` of the uint8 panel where imageio is
missing), and wandb only when the caller names a project and the package
imports. Without a `log_dir` nothing is written to disk. Inside a process
group only rank 0 logs: elsewhere the logger opens nothing and every
method returns at once.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from neurons_tpu_torch.parallel.distributed import is_main_process


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 wandb_project: Optional[str] = None,
                 run_name: Optional[str] = None,
                 config: Optional[Dict[str, Any]] = None):
        self._fh = None
        self._wandb = None
        self._dir = log_dir
        if not is_main_process():
            return
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        if wandb_project:
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                self._wandb = wandb
                wandb.init(project=wandb_project, name=run_name,
                           config=config or {})

    def log(self, msg: str) -> None:
        if is_main_process():
            print(msg, flush=True)

    def log_metrics(self, metrics: Dict[str, Any],
                    step: Optional[int] = None) -> None:
        if not is_main_process():
            return
        row = {k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in metrics.items()}
        row["_time"] = time.time()
        if step is not None:
            row["_step"] = int(step)
        if self._fh:
            self._fh.write(json.dumps(row) + "\n")
            self._fh.flush()
        if self._wandb:
            self._wandb.log(row, step=step)

    def log_images(self, images: Dict[str, Any],
                   step: Optional[int] = None,
                   caption: Optional[str] = None) -> None:
        """Image panels: `images` maps a panel name to [H, W], [H, W, C] or
        [N, H, W(, C)] values in [0, 1] (numpy or tensors; a leading batch
        is tiled side by side)."""
        if not is_main_process():
            return
        panels = {}
        for name, img in images.items():
            if hasattr(img, "detach"):
                img = img.detach().cpu().numpy()
            a = np.asarray(img, np.float32)
            if a.ndim == 4 or (a.ndim == 3 and a.shape[-1] not in (1, 3)):
                a = np.concatenate(list(a), axis=1)  # tile batch on width
            if a.ndim == 3 and a.shape[-1] == 1:
                a = a[..., 0]
            panels[name] = np.clip(a, 0.0, 1.0)
        if self._fh:
            img_dir = os.path.join(self._dir, "images")
            os.makedirs(img_dir, exist_ok=True)
            for name, a in panels.items():
                tag = f"step{step}_" if step is not None else ""
                self._write_png(a, os.path.join(img_dir, f"{tag}{name}.png"))
        if self._wandb:
            self._wandb.log(
                {name: self._wandb.Image(a, caption=caption)
                 for name, a in panels.items()}, step=step)

    @staticmethod
    def _write_png(a, path: str) -> None:
        u8 = (np.asarray(a) * 255).astype(np.uint8)
        try:
            import imageio
            imageio.imwrite(path, u8)
        except Exception:  # no imageio, or it cannot write: keep the pixels
            np.save(path + ".npy", u8)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._wandb:
            self._wandb.finish()
            self._wandb = None
