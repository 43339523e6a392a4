"""Dataset and weights download (reference download_dataset.py:1-15).

Counterpart of neurons_tpu/data/download.py: pulls the CC2017 tensor dump
and the NEURONS masks and annotations, or the AnimateDiff weights, from
the HF hub. `huggingface_hub` is imported only when a download starts; a
missing package raises a RuntimeError that says so.
"""

from __future__ import annotations

import os

# name -> (repo_id, repo_type, allow_patterns): the reference's two
# snapshot_download calls. The tensor dump is a dataset repo pulled whole;
# the masks and annotations sit in the NEURONS model repo and must be
# filtered by pattern (the same repo holds the >60 GB EXP dump)
DATASETS = {
    "cc2017": ("gongzx/cc2017_dataset", "dataset", None),
    "neurons_masks": ("McGregorW/NEURONS", "model",
                      ["masks/*", "qwen_annotation/*"]),
}

# reference README.md:31-99 and AnimateDiff's auto_download (util.py:77-89)
WEIGHTS = {
    "animatediff": ("guoyww/animatediff", "model",
                    ["v3_sd15_mm.ckpt", "v3_sd15_adapter.ckpt",
                     "v3_sd15_sparsectrl_rgb.ckpt"]),
    "neurons_exp": ("McGregorW/NEURONS", "model", None),  # EXP dump (>60GB)
}


def _hub():
    try:
        import huggingface_hub
    except ImportError as e:
        raise RuntimeError("huggingface_hub is required to download the "
                           "dataset") from e
    return huggingface_hub


def download(root_dir: str = "./cc2017_dataset",
             repos=("cc2017", "neurons_masks")) -> None:
    hub = _hub()
    os.makedirs(root_dir, exist_ok=True)
    for name in repos:
        repo, rtype, patterns = DATASETS[name]
        kw = {"allow_patterns": patterns} if patterns else {}
        hub.snapshot_download(repo_id=repo, repo_type=rtype,
                              local_dir=root_dir,
                              local_dir_use_symlinks=False, **kw)
        print(f"downloaded {repo} -> {root_dir}")


def download_weights(weights_dir: str = "./pretrained_weights",
                     bundles=("animatediff",)) -> None:
    """auto_download (reference animatediff/utils/util.py:77-89): a file
    already present is kept, every other one fetched."""
    hub = _hub()
    os.makedirs(weights_dir, exist_ok=True)
    for name in bundles:
        repo, rtype, files = WEIGHTS[name]
        if files is None:
            hub.snapshot_download(repo_id=repo, repo_type=rtype,
                                  local_dir=weights_dir)
            continue
        for f in files:
            if os.path.exists(os.path.join(weights_dir, f)):
                continue
            hub.hf_hub_download(repo_id=repo, filename=f, repo_type=rtype,
                                local_dir=weights_dir)
            print(f"downloaded {repo}/{f} -> {weights_dir}")


if __name__ == "__main__":
    import sys

    download(sys.argv[1] if len(sys.argv) > 1 else "./cc2017_dataset")
