"""Checkpoints of stages 1 and 2: save, load, overlay, background writes,
and the two consumers of the trained tags.

Counterpart of neurons_tpu/utils/checkpoint.py, and of the checkpoint
reads of the JAX package's CLI (cli.py:360-397 and :472-480). One
directory per tag, as the JAX package's Orbax checkpoints have it
(`exists` is `isdir`); inside it one `torch.save` payload

    {"params": {dotted name: CPU tensor}, "opt_state": the optimizer's
     state_dict() (absent for params-only tags), "step": int,
     "epoch": int, "extra": dict (absent when empty)}

Tags: `brain_model` (stage 1's best core, params only), `brain_model_last`
(stage 1's full state), `brain_model_core` (stage 2's frozen core, written
once), `brain_model_prior` (stage 2's best trained subtree) and
`brain_model_prior_last` (stage 2's state: the trained subtree mid-run,
the full tree at the end).

Writes are atomic: the payload goes to `<tag>.tmp/`, is fsync'ed, and the
directory then takes the tag's place (the old one renamed to `<tag>.old`
first and removed after), so a half-written payload is never a tag; a
crash between the two renames leaves `<tag>.old`, which the next access
puts back. Loads read on the CPU with `weights_only=True` and `mmap=True`.

Inside a process group rank 0 alone writes: `save_ckpt` on another rank
returns the tag's path and writes nothing, `AsyncCkptWriter` starts no
thread there, and only rank 0 puts back or removes a `<tag>.old` (another
rank's access would race rank 0's rename). Every rank reads.
"""

from __future__ import annotations

import os
import queue
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from neurons_tpu_torch.parallel import distributed

PAYLOAD = "payload.pt"

#: seconds and bytes of the last save of each tag: {"bytes", "copy_s" (the
#: device-to-host copy), "write_s" (torch.save, fsync and the rename)}
LAST_SAVE_STATS: Dict[str, Dict[str, float]] = {}


def map_tensors(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """`tree` (nested dicts, lists and tuples) with `fn` applied to every
    tensor leaf; other leaves are kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _settle(path: str) -> None:
    """Finish a swap a crash interrupted: `<tag>.old` without `<tag>` is
    put back; beside a complete `<tag>` it is removed. Rank 0 only."""
    old = path + ".old"
    if distributed.is_main_process() and os.path.isdir(old):
        if os.path.isdir(path):
            shutil.rmtree(old)
        else:
            os.replace(old, path)


def save_ckpt(directory: str, tag: str, *, params: Dict[str, torch.Tensor],
              opt_state: Optional[Dict] = None, step: int = 0,
              epoch: int = 0, extra: Optional[Dict] = None) -> str:
    """Write `params` (and `opt_state`, an optimizer state_dict) under
    `directory/tag`, atomically; tensors are copied to the host first.
    Returns the tag's path. Off rank 0 it writes nothing."""
    path = os.path.abspath(os.path.join(directory, tag))
    if not distributed.is_main_process():
        return path
    os.makedirs(directory, exist_ok=True)
    t0 = time.perf_counter()
    payload = {"params": map_tensors(lambda t: t.detach().cpu(), params),
               "step": int(step), "epoch": int(epoch)}
    if opt_state is not None:
        payload["opt_state"] = map_tensors(lambda t: t.detach().cpu(),
                                           opt_state)
    if extra:
        payload["extra"] = dict(extra)
    t1 = time.perf_counter()
    _settle(path)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    with open(os.path.join(tmp, PAYLOAD), "wb") as fh:
        torch.save(payload, fh)
        fh.flush()
        os.fsync(fh.fileno())
    _fsync_dir(tmp)
    old = path + ".old"
    if os.path.isdir(path):
        os.replace(path, old)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
    shutil.rmtree(old, ignore_errors=True)
    LAST_SAVE_STATS[tag] = {
        "bytes": os.path.getsize(os.path.join(path, PAYLOAD)),
        "copy_s": t1 - t0, "write_s": time.perf_counter() - t1}
    return path


def load_ckpt(directory: str, tag: str) -> Dict:
    """The payload of `directory/tag`, its tensors on the CPU (memory-mapped
    from the file)."""
    path = os.path.abspath(os.path.join(directory, tag))
    _settle(path)
    return torch.load(os.path.join(path, PAYLOAD), map_location="cpu",
                      weights_only=True, mmap=True)


def exists(directory: str, tag: str) -> bool:
    path = os.path.join(directory, tag)
    _settle(path)
    return os.path.isdir(path)


def restore_into(target_params: Any, ckpt_params: Any) -> Any:
    """strict=False layering: overlay the checkpoint's entries onto the
    target (nested dicts), keeping target entries it lacks and dropping
    its entries the target lacks."""
    if isinstance(target_params, dict) and isinstance(ckpt_params, dict):
        out = dict(target_params)
        for k, v in ckpt_params.items():
            if k in target_params:
                out[k] = restore_into(target_params[k], v)
        return out
    return ckpt_params if ckpt_params is not None else target_params


def merge_overlays(*overlays: Any) -> Any:
    """Deep-merge partial param trees; later overlays win on conflicting
    leaves and, unlike `restore_into`, keys absent from earlier trees are
    kept. None when nothing is merged."""

    def merge(a, b):
        if isinstance(a, dict) and isinstance(b, dict):
            out = dict(a)
            for k, v in b.items():
                out[k] = merge(a[k], v) if k in a else v
            return out
        return b

    result: Any = {}
    for o in overlays:
        if o is not None:
            result = merge(result, o)
    return result or None


class AsyncCkptWriter:
    """Overlap a checkpoint's device-to-host copy and write with compute.

    `submit` snapshots the payload on its device (a copy, so the training
    loop may update its tensors in place at once) and one daemon thread
    runs `save_ckpt` on it. One thread serialises the writes, so a later
    save of a tag lands last; a queue of `max_pending` gives backpressure.
    `drain()` waits for every queued write and re-raises the first writer
    error; call it before a synchronous save of the same tag and at the
    end. The snapshot costs device memory of the payload's size. Off rank
    0 it starts no thread and `submit` does nothing."""

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = None
        if distributed.is_main_process():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="ckpt-writer")
            self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            directory, tag, payload = item
            try:
                save_ckpt(directory, tag, **payload)
            except Exception as e:  # surfaced by submit and drain
                if self._err is None:
                    self._err = e
            finally:
                self._q.task_done()

    @staticmethod
    def _snapshot(tree: Any) -> Any:
        return map_tensors(lambda t: t.detach().clone(), tree)

    def submit(self, directory: str, tag: str, *,
               params: Dict[str, torch.Tensor], opt_state: Optional[Dict] = None,
               step: int = 0, epoch: int = 0,
               extra: Optional[Dict] = None) -> None:
        """Snapshot and enqueue a save (blocks while `max_pending` are
        queued). A writer error raises here and stays set until `drain`
        reports it."""
        if self._err is not None:
            raise self._err
        if self._thread is None:
            return
        payload = {"params": self._snapshot(params),
                   "opt_state": (self._snapshot(opt_state)
                                 if opt_state is not None else None),
                   "step": step, "epoch": epoch, "extra": extra}
        self._q.put((directory, tag, payload))

    def drain(self) -> None:
        """Wait for every queued write; re-raise (and then clear) the first
        writer error."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        self.drain()
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=60)

    def abort(self) -> None:
        """Shut down without draining, for exception paths: drop the queued
        snapshots (and their device memory) and stop the thread."""
        try:
            while True:
                self._q.get_nowait()
                self._q.task_done()
        except queue.Empty:
            pass
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)


# ------------------------------------------- consumers of trained tags ----

def _overlay(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> int:
    """Copy every entry of `params` that names a parameter of `model` into
    it (cast to its type); returns how many."""
    own = dict(model.named_parameters())
    n = 0
    with torch.no_grad():
        for name, value in params.items():
            if name in own:
                own[name].copy_(value)
                n += 1
    return n


def load_stage1_core(ckpt_dir: str) -> Optional[Dict[str, torch.Tensor]]:
    """Stage 1's core for stage 2 (`run_stage2(core_params=...)`): the
    best-metric `brain_model`, else `brain_model_last`; None when neither
    exists."""
    for tag in ("brain_model", "brain_model_last"):
        if exists(ckpt_dir, tag):
            print(f"--- core from {tag} ---", flush=True)
            return load_ckpt(ckpt_dir, tag)["params"]
    return None


def load_decoupler_params(ckpt_dir: str,
                          model: torch.nn.Module) -> torch.nn.Module:
    """Overlay stage 2's `brain_model_prior_last` onto `model` (a
    NeuronsDecoupler, in place) and return it. A mid-run payload carries
    the trained subtree only: the frozen core then comes from
    `brain_model_core`, else from stage 1's `brain_model_last` or
    `brain_model`; with none of them this raises rather than leave the
    model's own (random) core."""
    tag = "brain_model_prior_last"
    if not exists(ckpt_dir, tag):
        raise FileNotFoundError(f"{ckpt_dir}/{tag} does not exist")
    params = load_ckpt(ckpt_dir, tag)["params"]
    if not any(n.startswith("core.") for n in params):
        core_tag = next((t for t in ("brain_model_core", "brain_model_last",
                                     "brain_model")
                         if exists(ckpt_dir, t)), None)
        if core_tag is None:
            raise RuntimeError(
                f"{ckpt_dir}/{tag} carries only the trained decoupler "
                f"subtree (a mid-run save) and no frozen-core tag "
                f"(brain_model_core, brain_model_last or brain_model) lies "
                f"beside it: refusing to leave the model's own core")
        core = load_ckpt(ckpt_dir, core_tag)["params"]
        if not any(n.startswith("core.") for n in core):
            core = {"core." + n: v for n, v in core.items()}  # stage-1 tags
        _overlay(model, core)
        print(f"--- overlaid the frozen core from {core_tag} ---", flush=True)
    _overlay(model, params)
    print(f"--- loaded {tag} ---", flush=True)
    return model
