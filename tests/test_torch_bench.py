"""The port's top-level scripts on the CPU: bench_torch.py and the launch
counts chip_smoke.py holds the card to.

`bench_torch.py` runs the tiny configuration on the CPU
(BENCH_TINY=1 BENCH_PLATFORM=cpu, its only way there), exact and under the
"max" fast preset's knobs, and its last line is bench.py's JSON. Without
BENCH_TINY it refuses the CPU and prints no result. Neither script
imports JAX.

`chip_smoke.py:sampler_launches` counts a clip's flash and temporal
launches from the step schedule; here it is held to a counted run of the
tiny samplers on the CPU (the two kernel wrappers replaced by counting
stand-ins that compute the plain versions) for the exact path and every
fast path, and to the counts worked out by hand for the full-width clip
(models built on the meta device).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from neurons_tpu_torch import config  # noqa: E402

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the tiny tensors: the suite's workers share
    the cores, and oversubscribed OpenMP threads stall tiny ops (six
    parallel runs of the counted-run test took over 900 s at the default
    count and 12 s at one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_bench(env_extra, timeout=300):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(env_extra, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(REPO / "bench_torch.py")],
                          env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("knobs", [
    {}, {"BENCH_TGATE": "2", "BENCH_TGATE_VIDEO": "2",
         "BENCH_TGATE_PAB": "2"}], ids=["exact", "tgate_pab"])
def test_bench_torch_tiny_cpu_prints_the_bench_line(knobs):
    out = run_bench({"BENCH_TINY": "1", "BENCH_PLATFORM": "cpu", **knobs})
    assert out.returncode == 0, out.stderr[-2000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(last) == BENCH_KEYS
    assert last["metric"] == "sec_per_clip_e2e_stage3+5"
    assert last["unit"] == "s/clip" and last["value"] > 0
    assert last["vs_baseline"] == pytest.approx(10.0 / last["value"],
                                                rel=1e-2)
    if knobs:
        assert "'tgate_step': 2, 'tgate_pab': 2" in out.stderr


def test_bench_torch_refuses_the_cpu_without_tiny():
    out = run_bench({"BENCH_PLATFORM": "cpu"}, timeout=120)
    assert out.returncode != 0 and "BENCH_TINY" in out.stderr
    assert out.stdout.strip() == ""


def test_bench_torch_fast_knobs(monkeypatch):
    import bench_torch
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    s3, s5 = bench_torch.fast_knobs()
    assert s3 == dict(tgate_step=0, tgate_pab=0, encoder_reuse=1, pab=None,
                      pab_range=None, deep_cache=0)
    assert s5 == dict(encoder_reuse=1, tgate_step=0, tgate_pab=0, pab=None,
                      pab_range=None)
    for k, v in {"BENCH_TGATE": "33", "BENCH_TGATE_VIDEO": "10",
                 "BENCH_TGATE_PAB": "2", "BENCH_PAB": "2,4,8",
                 "BENCH_PAB_KF": "2,8", "BENCH_PAB_RANGE": "2,23",
                 "BENCH_ENC_REUSE": "3", "BENCH_DEEPCACHE": "4"}.items():
        monkeypatch.setenv(k, v)
    s3, s5 = bench_torch.fast_knobs()
    assert s3 == dict(tgate_step=33, tgate_pab=2, encoder_reuse=3,
                      pab=(2, 8), pab_range=(2, 23), deep_cache=4)
    assert s5 == dict(encoder_reuse=3, tgate_step=10, tgate_pab=2,
                      pab=(2, 4, 8), pab_range=(2, 23))


@pytest.mark.parametrize("script", ["bench_torch.py", "chip_smoke.py"])
def test_scripts_import_no_jax(script):
    banned = ("jax", "jaxlib", "flax", "optax", "neurons_tpu")
    for node in ast.walk(ast.parse((REPO / script).read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in banned, f"{script}: {name}"


# --- chip_smoke.py's launch counts --------------------------------------------

FAST = {
    "tgate": ({"tgate_step": 3}, {"tgate_step": 3}),
    "tgate_pab": ({"tgate_step": 2, "tgate_pab": 2},
                  {"tgate_step": 2, "tgate_pab": 2}),
    "pab": ({"pab": (2, 4), "pab_range": (1, 6)},
            {"pab": (2, 4, 8), "pab_range": (2, 6)}),
    "encoder_reuse": ({"encoder_reuse": 3}, {"encoder_reuse": 2}),
    "deep_cache": ({"deep_cache": 3}, {}),
}


@pytest.fixture(scope="module")
def tiny_clip():
    from neurons_tpu_torch.models.clip import CLIPTextConfig
    from neurons_tpu_torch.models.gpt2 import tiny_gpt2_config
    pcfg = config.tiny_pipeline_config()
    pcfg = config.replace(
        pcfg, unet2d=config.replace(pcfg.unet2d, adm_in_channels=1024),
        sampler=config.replace(pcfg.sampler, unclip_steps=7, video_steps=7))
    models = chip_smoke.build_models((pcfg, tiny_gpt2_config()), "cpu",
                                     torch.float32, 7)
    models += chip_smoke.build_video_models(pcfg, CLIPTextConfig.tiny(),
                                            "cpu", torch.float32, 7)
    return pcfg, models


def counted_samplers(monkeypatch, pcfg, models, s3_opts, s5_opts):
    """The tiny samplers on the CPU with the two kernel wrappers replaced
    by stand-ins that count as the wrappers do: {kernel: {key: n}}."""
    from neurons_tpu_torch.ops import attention as attn
    from neurons_tpu_torch.ops import temporal_attention as ta
    from neurons_tpu_torch.pipelines import keyframe as kf
    from neurons_tpu_torch.pipelines.video import reconstruct_video

    def flash(q, k, v, scale=None, bias=None, return_lse=False):
        attn.FLASH_FWD_LAUNCHES.add((*q.shape[:3], k.shape[2], q.shape[3],
                                     str(q.dtype).split(".")[-1], ""))
        return attn.attention_reference(q, k, v, scale=scale)

    def temporal(q, k, v, f, h, scale):
        ta.TEMPORAL_ATTN_LAUNCHES.add((*q.shape, f, h,
                                       str(q.dtype).split(".")[-1]))
        return ta.temporal_attention_reference(q, k, v, f, h, scale)

    monkeypatch.setattr(attn, "flash_attention_fwd", flash)
    monkeypatch.setattr(ta, "temporal_attention_fwd", temporal)
    _, unet, vae, _, unet3d, cn = models
    counters = {"flash_attn_fwd": attn.FLASH_FWD_LAUNCHES,
                "temporal_attn_fwd": ta.TEMPORAL_ATTN_LAUNCHES}
    for c in counters.values():
        c.reset()
    g = torch.Generator().manual_seed(0)
    ctx = pcfg.unet3d.cross_attention_dim
    kf.unclip_sample(unet, vae, torch.randn((1, 16, 32), generator=g),
                     num_steps=pcfg.sampler.unclip_steps, latent_hw=32,
                     generator=g, **s3_opts)
    reconstruct_video(unet3d, cn, vae, torch.rand((1, 2, 3, 32, 32)),
                      torch.rand((1, 3, 32, 32)), torch.randn((1, 5, ctx)),
                      torch.randn((1, 5, ctx)),
                      num_steps=pcfg.sampler.video_steps, n_frames=4,
                      generator=g, device="cpu", **s5_opts)
    out = {k: dict(c.by_shape) for k, c in counters.items()}
    for c in counters.values():
        c.reset()
    return out


def test_sampler_launches_match_a_counted_run(monkeypatch, tiny_clip):
    pcfg, models = tiny_clip
    kw = dict(latents=(32, 16), batch=1, dtype="float32")
    exact = counted_samplers(monkeypatch, pcfg, models, {}, {})
    exact_predicted = chip_smoke.sampler_launches(models, pcfg, {}, {}, **kw)
    assert all(exact_predicted.values())
    chip_smoke.check_launches("exact", exact, 1, exact_predicted, exact, 1,
                              exact_predicted)
    for name, (s3, s5) in FAST.items():
        got = counted_samplers(monkeypatch, pcfg, models, s3, s5)
        predicted = chip_smoke.sampler_launches(models, pcfg, s3, s5, **kw)
        chip_smoke.check_launches(name, got, 1, predicted, exact, 1,
                                  exact_predicted)
    # a wrong count is caught
    predicted = chip_smoke.sampler_launches(models, pcfg, *FAST["tgate"],
                                            **kw)
    with pytest.raises(AssertionError, match="count from the code"):
        chip_smoke.check_launches("exact as tgate", exact, 1, predicted,
                                  exact, 1, exact_predicted)


def test_sampler_launches_full_width():
    from neurons_tpu_torch.models.sparse_controlnet import \
        SparseControlNetModel
    from neurons_tpu_torch.models.unet2d import UNetModel
    from neurons_tpu_torch.models.unet3d import UNet3DModel
    pcfg = config.PipelineConfig()
    models = (None, UNetModel(pcfg.unet2d, device="meta"), None, None,
              UNet3DModel(pcfg.unet3d, device="meta"),
              SparseControlNetModel(pcfg.unet3d, device="meta"))

    def totals(s3, s5):
        got = chip_smoke.sampler_launches(models, pcfg, s3, s5)
        unet = sum(v for k, v in got["flash_attn_fwd"].items()
                   if k[1] in (10, 20))
        return unet, got

    # 140 a UNet2D step (70 self + 70 cross: 10 blocks at 48^2, 60 at
    # 24^2) x 38 steps; under "max" 10 full steps, 14 gated captures of
    # the 70 self-attentions at batch 1 and 14 reuse steps of none
    exact_unet, exact = totals({}, {})
    assert exact_unet == 5320
    fast_unet, fast = totals(*config.fast_options("max"))
    assert fast_unet == 1400 + 980 == 2380
    assert fast["flash_attn_fwd"][(1, 20, 576, 576, 64, "bfloat16", "")] \
        == 14 * 60
    # stage 5: a full step 10 UNet3D + 4 SparseCtrl flash launches and
    # 40 + 8 temporal ones; a gated capture 10 and 40 at 16 rows
    assert sum(exact["temporal_attn_fwd"].values()) == 25 * 48
    assert sum(fast["temporal_attn_fwd"].values()) == 10 * 48 + 8 * 40
    video = sum(v for k, v in fast["flash_attn_fwd"].items() if k[1] == 8)
    assert video == 10 * 14 + 8 * 10
    # 5 motion modules of 2 attentions at 32^2 (2 down, 3 up)
    assert fast["temporal_attn_fwd"][(16, 1024, 320, 16, 8, "bfloat16")] \
        == 8 * 10


# --- chip_smoke.py's f32 route totals and the TF32 instances' ptxas gate ----

def test_f32_route_totals_sum_launches_times_time_per_unit():
    def rec(ms):
        return dict(ms=ms, device_ms=ms / 2, bound_ms=1e-3, plain_ms=2 * ms,
                    library_ms=3 * ms, route="flash_fwd_tf32_kernel")

    vit, clip = ((1, 12, 197, 197, 64, "float32", ""),
                 (6, 16, 257, 257, 64, "float32", ""))
    records = {vit: rec(0.02), clip: rec(0.05)}
    (t,) = chip_smoke.f32_route_totals(
        records, [("scored clip", {vit: 288 * 4, clip: 24 * 4}, 4)])
    kernel_s = (288 * 0.02 + 24 * 0.05) / 1e3
    assert t["path"] == "scored clip" and t["launches"] == 312
    assert t["kernel_s"] == pytest.approx(kernel_s)
    assert t["device_s"] == pytest.approx(kernel_s / 2)
    assert t["plain_s"] == pytest.approx(2 * kernel_s)
    assert t["library_s"] == pytest.approx(3 * kernel_s)
    assert t["bound_s"] == pytest.approx(312 * 1e-3 / 1e3)
    assert t["routes"] == ["flash_fwd_tf32_kernel"]


def _ptxas(dk, bias, lse, registers, spill=0):
    """One -Xptxas -v entry of a TF32 register kernel instance (the mangled
    name nvcc gives a kernel in an anonymous namespace)."""
    return dict(source="flash_attn_fwd",
                function=(f"_ZN50_GLOBAL__N__0_flash_attn_fwd_cu21flash_fwd_"
                          f"tf32_kernelILi{dk}ELb{int(bias)}ELb{int(lse)}EEEv"
                          f"NS_6ParamsE"),
                registers=registers, spill_stores=spill, spill_loads=2 * spill)


def test_tf32_instances_are_read_and_gated():
    ptxas = [_ptxas(dk, bias, lse, 100 + dk)
             for dk in (32, 64, 128) for bias in (0, 1) for lse in (0, 1)]
    ptxas.append(dict(source="flash_attn_fwd", registers=150,
                      function="_ZN3_GLOBAL__N_120flash_fwd_reg_kernelILi64E"))
    got = chip_smoke.tf32_instances(ptxas)
    assert sorted((i["dk"], i["bias"], i["lse"]) for i in got) == sorted(
        (dk, b, l) for dk in (32, 64, 128) for b in (False, True)
        for l in (False, True))
    assert {i["dk"]: i["registers"] for i in got} == {32: 132, 64: 164,
                                                      128: 228}
    with pytest.raises(AssertionError):  # an instance spills
        chip_smoke.tf32_instances(ptxas[:11] + [_ptxas(128, 1, 1, 255, 8)])
    with pytest.raises(AssertionError):  # an instance is missing
        chip_smoke.tf32_instances(ptxas[1:])


def _wide_ptxas(name, registers, spill=0):
    """One -Xptxas -v entry of a TF32 column-split kernel (mangled as nvcc
    names it in an anonymous namespace)."""
    return dict(source="flash_attn_fwd", function=(
        f"_ZN50_GLOBAL__N__0_flash_attn_fwd_cu{len(name)}{name}ENS_6ParamsE"),
        registers=registers, spill_stores=spill, spill_loads=spill)


def test_wide_tf32_kernels_are_read_and_gated():
    # the forward's four instances and the backward's two passes; the
    # TF32 register kernel's instances are not among them
    wide = ([_wide_ptxas(f"flash_fwd_wide_tf32_kernelILb{b}ELb{l}EE", 200)
             for b in (0, 1) for l in (0, 1)]
            + [_wide_ptxas("flash_bwd_dkdv_wide_tf32_kernel", 208),
               _wide_ptxas("flash_bwd_dq_wide_tf32_kernel", 176)])
    ptxas = wide + [_ptxas(64, 0, 0, 164)]
    got = chip_smoke.wide_tf32_kernels(ptxas)
    assert [i["function"] for i in got] == [f["function"] for f in wide]
    with pytest.raises(AssertionError):  # one spills
        chip_smoke.wide_tf32_kernels(
            wide[:5] + [_wide_ptxas("flash_bwd_dq_wide_tf32_kernel", 255, 4)])
    with pytest.raises(AssertionError):  # one is missing
        chip_smoke.wide_tf32_kernels(ptxas[1:])


def test_tf32_bwd_instances_are_read():
    # the TF32 register backward's passes at each padded head dim, biased
    # or not, and its dbias kernel at each; neither the column-split
    # kernels nor the bf16 register ones are among them
    names = [f"flash_bwd_{k}_tf32_kernelILi{dk}ELb{b}EEEvNS_6ParamsE"
             for dk in (32, 64, 128) for k in ("dkdv", "dq") for b in (0, 1)]
    names += [f"flash_bwd_dbias_tf32_kernelILi{dk}EEEvNS_6ParamsEi"
              for dk in (32, 64, 128)]
    ptxas = [dict(source="flash_attn_bwd", registers=128 + i,
                  function=f"_ZN50_GLOBAL__N__0_flash_attn_bwd_cu{len(n)}{n}",
                  spill_stores=4 * (i == 3), spill_loads=4 * (i == 3))
             for i, n in enumerate(names)]
    others = [_wide_ptxas("flash_bwd_dkdv_wide_tf32_kernel", 208),
              dict(source="flash_attn_bwd", registers=200, function=(
                  "_ZN3_GLOBAL__N_125flash_bwd_dkdv_reg_kernelILi64ELb1EEEv"))]
    got = chip_smoke.tf32_bwd_instances(ptxas + others)
    assert sorted((i["kernel"], i["dk"], i["bias"]) for i in got) == sorted(
        [(k, dk, b) for dk in (32, 64, 128) for k in ("dkdv", "dq")
         for b in (False, True)] + [("dbias", dk, True) for dk in (32, 64, 128)])
    assert [i["spill_stores"] for i in got].count(4) == 1
    with pytest.raises(AssertionError):  # an instance is missing
        chip_smoke.tf32_bwd_instances(ptxas[1:] + others)


def test_wgmma_bwd_instances_are_read_and_gated():
    # the wgmma backward's two passes at d 32, 64 and 128 (mangled as nvcc
    # names them in an anonymous namespace, CUtensorMap arguments and all);
    # neither the register backward nor the wgmma forward is among them
    names = [f"flash_bwd_{k}_wgmma_kernelILi{d}EEEv14CUtensorMap_stS1_S1_S1_"
             f"NS_9BwdParamsE" for d in (32, 64, 128) for k in ("dkdv", "dq")]
    ptxas = [dict(source="flash_attn_bwd_sm90", registers=168 - 40 * (i < 3),
                  function=f"_ZN55_GLOBAL__N__0_flash_attn_bwd_sm90_cu"
                           f"{len(n)}{n}", spill_stores=0, spill_loads=0)
             for i, n in enumerate(names)]
    others = [dict(source="flash_attn_bwd", registers=200, function=(
        "_ZN3_GLOBAL__N_125flash_bwd_dkdv_reg_kernelILi64ELb1EEEv")),
        dict(source="flash_attn_fwd_sm90", registers=168, function=(
            "_ZN3_GLOBAL__N_122flash_fwd_wgmma_kernelILi64ELi1ELb1EEEv"))]
    got = chip_smoke.wgmma_bwd_instances(ptxas + others, build_log="")
    assert sorted((i["d"], i["kernel"]) for i in got) == sorted(
        (d, k) for d in (32, 64, 128) for k in ("dkdv", "dq"))
    with pytest.raises(AssertionError):  # an instance is missing
        chip_smoke.wgmma_bwd_instances(ptxas[1:], build_log="")
    with pytest.raises(AssertionError):  # an instance spills
        chip_smoke.wgmma_bwd_instances(
            ptxas[:5] + [dict(ptxas[5], spill_stores=8, spill_loads=8)],
            build_log="")
    serialized = ("ptxas info    : (C7512) Potential Performance Loss: "
                  "wgmma.mma_async instructions are serialized due to "
                  "insufficient register resources for the function")
    with pytest.raises(AssertionError):  # ptxas serialized the products
        chip_smoke.wgmma_bwd_instances(ptxas, build_log=serialized)


def test_wide_wgmma_instances_are_read_and_gated():
    # the wide wgmma forward's instance and its key parts' combine kernel
    # (mangled as nvcc names them in its anonymous namespace); neither the
    # d <= 128 wgmma forward nor the column-split kernels are among them
    ns = "_ZN60_GLOBAL__N__7a32da72_27_flash_attn_fwd_wide_sm90_cu_2e576f74"
    ptxas = [
        dict(source="flash_attn_fwd_wide_sm90", registers=246,
             function=ns + "27flash_fwd_wide_wgmma_kernelINS_7WideCfgILi32E"
             "EEEEv14CUtensorMap_stS3_S3_NS_10WideParamsE",
             spill_stores=0, spill_loads=0),
        dict(source="flash_attn_fwd_wide_sm90", registers=40,
             function=ns + "29flash_fwd_wide_combine_kernelEPKfPK6float2P13"
             "__nv_bfloat16xiif", spill_stores=0, spill_loads=0)]
    others = [dict(source="flash_attn_fwd", registers=200, function=(
        "_ZN3_GLOBAL__N_121flash_fwd_wide_kernelILb0ELb0EEEvNS_6ParamsE")),
        _wide_ptxas("flash_fwd_wide_tf32_kernel", 208),
        dict(source="flash_attn_fwd_sm90", registers=168, function=(
            "_ZN3_GLOBAL__N_122flash_fwd_wgmma_kernelILi64ELi1ELb0EEEv"))]
    got = chip_smoke.wide_wgmma_kernels(ptxas + others, build_log="")
    assert [(i["kernel"], i["registers"]) for i in got] == [
        ("wgmma", 246), ("combine", 40)]
    with pytest.raises(AssertionError):  # the combine kernel is missing
        chip_smoke.wide_wgmma_kernels(ptxas[:1] + others, build_log="")
    with pytest.raises(AssertionError):  # the instance spills
        chip_smoke.wide_wgmma_kernels(
            [dict(ptxas[0], spill_stores=64, spill_loads=64), ptxas[1]],
            build_log="")
    serialized = ("ptxas info    : (C7512) Potential Performance Loss: "
                  "wgmma.mma_async instructions are serialized due to "
                  "insufficient register resources for the function")
    with pytest.raises(AssertionError):  # ptxas serialized the products
        chip_smoke.wide_wgmma_kernels(ptxas, build_log=serialized)
