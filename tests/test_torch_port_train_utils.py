"""The port's small training utilities against the JAX package on the CPU:
the sgm LR schedules (diffusion/lr_schedule.py) over every step of two
cycles, boundaries included (1e-6 relative); the EMA shadow (utils/ema.py;
1e-6); the diffusion loss and its sigma samplers (diffusion/loss.py) with
JAX's draws fed (1e-6); and data/download.py against a local mock of the
HF hub (tests/test_download.py's server), never the network."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_download as hub_mock
from neurons_tpu.data import download as jdl
from neurons_tpu.diffusion import loss as jloss
from neurons_tpu.diffusion import lr_schedule as jlr
from neurons_tpu.utils import ema as jema
from neurons_tpu_torch.data import download as tdl
from neurons_tpu_torch.diffusion import loss as tloss
from neurons_tpu_torch.diffusion import lr_schedule as tlr
from neurons_tpu_torch.diffusion.schedule import sd_sigmas
from neurons_tpu_torch.utils import ema as tema

TOL = 1e-6

CYCLES = dict(warm_up_steps=[5, 3], f_min=[0.1, 0.05], f_max=[1.0, 0.6],
              f_start=[1e-3, 0.2], cycle_lengths=[20, 12])
SCHEDULES = {
    "warmup_cosine": (lambda m: m.warmup_cosine(7, 1e-4, 1e-2, 1e-5, 40),
                      50),
    "cyclic_warmup_cosine": (lambda m: m.cyclic_warmup_cosine(**CYCLES), 40),
    "cyclic_warmup_linear": (lambda m: m.cyclic_warmup_linear(**CYCLES), 40),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_lr_schedule_matches_jax_at_every_step(name):
    build, n = SCHEDULES[name]
    steps = np.arange(n)
    want = np.asarray(build(jlr)(jnp.asarray(steps)))
    fn = build(tlr)
    got = np.array([fn(int(s)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-9)
    assert len(np.unique(want)) > n // 2


def test_cycle_boundary_puts_the_last_step_in_the_earlier_cycle():
    # cumulative lengths 20, 32: step 20 is still cycle 0 (n <= cum)
    for n, want in ((0, (0, 0)), (19, (0, 19)), (20, (0, 20)),
                    (21, (1, 1)), (32, (1, 12)), (45, (1, 25))):
        c, n_c = jlr._cycle_state(jnp.asarray(n), [20, 12])
        assert (int(c), int(n_c)) == want
        assert tlr._cycle_state(n, [20, 12]) == want


def test_ema_matches_jax():
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    js = jema.init({k: jnp.asarray(v) for k, v in params.items()}, 0.99)
    ts = tema.init({k: torch.from_numpy(v) for k, v in params.items()}, 0.99)
    for i in range(25):  # past the (1 + n) / (10 + n) ramp
        new = {k: rng.standard_normal(v.shape).astype(np.float32)
               for k, v in params.items()}
        js = jema.update(js, {k: jnp.asarray(v) for k, v in new.items()})
        out = tema.update(ts, {k: torch.from_numpy(v)
                               for k, v in new.items()})
        assert out is ts
        for k in params:
            np.testing.assert_allclose(ts.shadow[k].numpy(),
                                       np.asarray(js.shadow[k]), rtol=TOL,
                                       atol=1e-7, err_msg=f"{k} step {i}")
    assert ts.num_updates == int(js.num_updates) == 25
    assert float(tema.decay_at(25, 0.99)) == float(
        jnp.minimum(0.99, (1.0 + 25) / (10.0 + 25)))
    live = {k: torch.from_numpy(v) for k, v in params.items()}
    run, restore = tema.swap(ts, live)
    jrun, jrestore = jema.swap(js, params)
    assert run is ts.shadow and restore is live
    assert jrun is js.shadow and jrestore is params
    # init copies: the shadow does not alias the live parameters
    p = torch.ones(3)
    s = tema.init({"p": p})
    p.add_(1)
    assert float(s.shadow["p"].sum()) == 3.0


def test_discrete_sigma_table_matches_jax():
    jt = jloss.discrete_sigma_sampler(1000)
    draws = np.asarray(jt(jax.random.PRNGKey(0), 4096))
    sampler = tloss.discrete_sigma_sampler(1000)
    table = sd_sigmas(1000, append_zero=False).flip(0).numpy()
    assert np.all(np.diff(table) > 0)
    assert np.isin(draws, table).all()  # JAX's draws come from this table
    got = sampler(64, torch.Generator().manual_seed(0))
    assert got.shape == (64,) and np.isin(got.numpy(), table).all()
    e = tloss.edm_sigma_sampler()(64, torch.Generator().manual_seed(0))
    assert e.shape == (64,) and bool((e > 0).all())


def _denoise_pair():
    w = np.random.default_rng(1).standard_normal((3,)).astype(np.float32)

    def j(x, s):
        return x * jnp.asarray(w)[None, :, None, None] / (1 + s[:, None, None,
                                                                  None] ** 2)

    def t(x, s):
        return x * torch.from_numpy(w)[None, :, None, None] / (
            1 + s[:, None, None, None] ** 2)

    return j, t


def _check_diffusion_loss(sampler, loss_type, offset, dtype):
    """The port's loss on JAX's draws (rebuilt from its key splits) against
    JAX's, on x in `dtype`; both denoisers record their inputs' types."""
    x = np.random.default_rng(2).standard_normal((4, 3, 6, 6)).astype(
        np.float32)
    key = jax.random.PRNGKey(3)
    jsamp = (jloss.discrete_sigma_sampler() if sampler == "discrete"
             else jloss.edm_sigma_sampler())
    tsamp = (tloss.discrete_sigma_sampler() if sampler == "discrete"
             else tloss.edm_sigma_sampler())
    jd0, td0 = _denoise_pair()
    seen = {}

    def jd(xn, s):
        seen["jax"] = (str(xn.dtype), str(s.dtype))
        return jd0(xn, s)

    def td(xn, s):
        seen["torch"] = (str(xn.dtype).split(".")[-1],
                         str(s.dtype).split(".")[-1])
        return td0(xn, s)

    w_j = (lambda s: 1.0 / (s + 1.0)) if offset else None
    w_t = (lambda s: 1.0 / (s + 1.0)) if offset else None
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = float(jloss.standard_diffusion_loss(
        jd, jx, key, jsamp, loss_type, offset, w_j))
    # JAX's draws, rebuilt from its key splits (noise and offset in x's type)
    k_sig, k_n, k_off = jax.random.split(key, 3)
    sig = np.array(jsamp(k_sig, 4))
    noise, off = (torch.from_numpy(np.array(
        jax.random.normal(k, shape, jx.dtype).astype(jnp.float32))).to(
            tx.dtype) for k, shape in ((k_n, x.shape), (k_off, (4, 1, 1, 1))))
    got = float(tloss.standard_diffusion_loss(
        td, tx, tsamp, loss_type, offset, w_t,
        sigmas=torch.from_numpy(sig), noise=noise, offset=off))
    assert want != 0.0
    # the denoiser sees f32 noised input and f32 sigmas in both, whatever
    # x's type (bf16 x times f32 sigmas promotes)
    assert seen["jax"] == seen["torch"] == ("float32", "float32"), seen
    np.testing.assert_allclose(got, want, rtol=TOL)
    # drawn from a generator when not given: finite, and reproducible
    g1 = tloss.standard_diffusion_loss(
        td, tx, tsamp, loss_type, offset, w_t,
        generator=torch.Generator().manual_seed(7))
    g2 = tloss.standard_diffusion_loss(
        td, tx, tsamp, loss_type, offset, w_t,
        generator=torch.Generator().manual_seed(7))
    assert torch.isfinite(g1) and float(g1) == float(g2)


@pytest.mark.parametrize("sampler", ["discrete", "edm"])
@pytest.mark.parametrize("loss_type", ["l2", "l1"])
@pytest.mark.parametrize("offset", [0.0, 0.1])
def test_standard_diffusion_loss_matches_jax(sampler, loss_type, offset):
    _check_diffusion_loss(sampler, loss_type, offset, "float32")


@pytest.mark.parametrize("sampler", ["discrete", "edm"])
@pytest.mark.parametrize("loss_type", ["l2", "l1"])
@pytest.mark.parametrize("offset", [0.0, 0.1])
def test_standard_diffusion_loss_matches_jax_bf16(sampler, loss_type,
                                                  offset):
    # bf16 x: the sigmas stay f32 as the reference's, so the noised input,
    # the denoiser's sigmas and the loss are f32 in both
    _check_diffusion_loss(sampler, loss_type, offset, "bfloat16")


@pytest.fixture(scope="module")
def hub_server():
    from http.server import ThreadingHTTPServer
    import threading
    srv = ThreadingHTTPServer(("127.0.0.1", 0), hub_mock._HubHandler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv.server_port
    srv.shutdown()
    t.join(timeout=10)


@pytest.fixture()
def mock_hub(hub_server, tmp_path, monkeypatch):
    monkeypatch.setenv("HF_ENDPOINT", f"http://127.0.0.1:{hub_server}")
    monkeypatch.setenv("HF_HUB_ETAG_TIMEOUT", "5")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    monkeypatch.setenv("HF_HUB_DISABLE_TELEMETRY", "1")
    monkeypatch.setenv("HF_HUB_OFFLINE", "0")
    hub_mock._reload_hub()
    yield
    monkeypatch.undo()
    hub_mock._reload_hub()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        if ".cache" in d.split(os.sep):
            continue
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_download_matches_jax(mock_hub, tmp_path):
    jdl.download(root_dir=str(tmp_path / "jax"))
    tdl.download(root_dir=str(tmp_path / "port"))
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    assert got["GT_test_3fps.pt"] == b"tensor-dump-bytes"
    assert "masks/test_mask.pt" in got and "EXP/huge_log.bin" not in got
    assert tdl.DATASETS == jdl.DATASETS and tdl.WEIGHTS == jdl.WEIGHTS


def test_download_weights_matches_jax(mock_hub, tmp_path):
    for root in ("jax", "port"):  # a file already there is kept
        os.makedirs(tmp_path / root)
        (tmp_path / root / "v3_sd15_mm.ckpt").write_bytes(b"kept")
    jdl.download_weights(weights_dir=str(tmp_path / "jax"))
    tdl.download_weights(weights_dir=str(tmp_path / "port"))
    got = _files(tmp_path / "port")
    assert got == _files(tmp_path / "jax")
    assert got["v3_sd15_mm.ckpt"] == b"kept"
    assert got["v3_sd15_adapter.ckpt"] == b"adapter"
    assert "v2_unwanted.ckpt" not in got


@pytest.mark.parametrize("fn", ["download", "download_weights"])
def test_missing_huggingface_hub_raises_runtime_error(fn, tmp_path,
                                                      monkeypatch):
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub is required"):
        getattr(tdl, fn)(str(tmp_path / "x"))
    assert not os.path.exists(tmp_path / "x")
