"""Parity of the port's stage 4 (neurons_tpu_torch.models.blip2, the BLIP-2
importer) with the JAX package, on the CPU in f32 at tiny size.

Both sides get the same weights: the JAX tree is shaped by
`jax.eval_shape` of the flax init, every leaf drawn from numpy
(`torch_port_utils.randomize`), and `load_jax_params` carries it into the
port. Module outputs are held within 1e-4 of their largest magnitude;
greedy tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.interop import torch_import as jti
from neurons_tpu.models import blip2 as jb
from neurons_tpu_torch.interop import torch_import as tti
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import blip2 as tb
from neurons_tpu_torch.ops import attention as tattn
from torch_port_utils import randomize, rel_err

TOL = 1e-4
MAX_LEN = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs six workers side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(cfg: jb.Blip2Config) -> tb.Blip2Config:
    return tb.Blip2Config(
        vision=tb.Blip2VisionConfig(**dataclasses.asdict(cfg.vision)),
        qformer=tb.Blip2QFormerConfig(**dataclasses.asdict(cfg.qformer)),
        opt=tb.OPTConfig(**dataclasses.asdict(cfg.opt)))


def make_pair(cfg: jb.Blip2Config, seed: int):
    """(JAX module, its params, the port module with the same weights)."""
    jm = jb.Blip2Captioner(cfg)
    hw = cfg.vision.image_size
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, hw, hw)),
        jnp.zeros((1, 2), jnp.int32)))["params"]
    params = randomize(shapes, seed)
    tm = tb.Blip2Captioner(port_config(cfg), device="cpu").eval()
    load_jax_params(tm, params)
    return jm, params, tm


def images(cfg, seed, b=3):
    hw = cfg.vision.image_size
    return np.random.default_rng(seed).standard_normal(
        (b, 3, hw, hw), dtype=np.float32)


@pytest.fixture(scope="module")
def tiny():
    cfg = jb.Blip2Config.tiny()
    return cfg, *make_pair(cfg, 3)


def japply(jm, params, method, *args):
    return np.asarray(jax.jit(lambda p, *a: jm.apply(
        {"params": p}, *a, method=method))(params, *args))


def test_vision_tower_matches_jax(tiny):
    cfg, jm, params, tm = tiny
    x = images(cfg, 0)
    want = japply(jm, params, lambda m, x: m.vision_model(x), x)
    with torch.no_grad():
        got = tm.vision_model(torch.from_numpy(x))
    assert got.shape == (3, (32 // 8) ** 2 + 1, 32)
    assert rel_err(got, want) < TOL


def test_qformer_matches_jax(tiny):
    cfg, jm, params, tm = tiny
    x = images(cfg, 1)

    def qformer(m, x):
        emb = m.vision_model(x)
        q = jnp.broadcast_to(m.query_tokens, (x.shape[0],)
                             + m.query_tokens.shape[1:])
        return m.qformer(q, emb)

    want = japply(jm, params, qformer, x)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = tm.qformer(tm.query_tokens.expand(3, -1, -1),
                         tm.vision_model(xt))
    assert got.shape == (3, cfg.qformer.num_query_tokens, 24)
    assert rel_err(got, want) < TOL


def test_opt_prefill_logits_match_jax(tiny):
    """The OPT decoder alone over a ragged mask (positions from the
    mask's cumsum, padded keys masked out)."""
    cfg, jm, params, tm = tiny
    rng = np.random.default_rng(2)
    embeds = rng.standard_normal((2, 9, 40), dtype=np.float32)
    mask = np.ones((2, 9), np.int32)
    mask[1, 6:] = 0

    def lm(m, e, a):
        return m.lm(e, a) @ jnp.asarray(m.embed_tokens).T

    want = japply(jm, params, lm, embeds, mask)
    with torch.no_grad():
        got = tm.lm(torch.from_numpy(embeds),
                    torch.from_numpy(mask).long()) @ tm.embed_tokens.T
    keep = mask.astype(bool)  # rows of padded queries are not compared
    assert rel_err(got[torch.from_numpy(keep)], want[keep]) < TOL


def test_forward_logits_match_jax(tiny):
    cfg, jm, params, tm = tiny
    x = images(cfg, 4)
    ids = np.random.default_rng(4).integers(0, 100, (3, 7)).astype(np.int32)
    want = japply(jm, params, jb.Blip2Captioner.__call__, x, ids)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ids).long())
    assert got.shape == (3, 4 + 7, 100)
    assert rel_err(got, want) < TOL


def _with_eos_bias(params, token: int, eos: int):
    """EOS embedded as 1.05 x `token`'s embedding: wherever the decode
    would pick `token` (a positive logit), it picks EOS instead."""
    emb = params["embed_tokens"].copy()
    emb[eos] = 1.05 * emb[token]
    return dict(params, embed_tokens=emb)


# seed 9: no EOS; seed 4 with EOS standing in for token 1, which that
# instance emits at different steps in different rows
@pytest.mark.parametrize("seed,eos_for", [(9, None), (4, 1)],
                         ids=["no_eos", "early_eos"])
def test_generate_matches_jax_and_nocache(seed, eos_for):
    cfg = jb.Blip2Config.tiny()
    jm, params, _ = make_pair(cfg, seed)
    eos = cfg.opt.eos_token_id
    if eos_for is not None:
        params = _with_eos_bias(params, eos_for, eos)
    tm = tb.Blip2Captioner(port_config(cfg), device="cpu").eval()
    load_jax_params(tm, params)
    x = np.random.default_rng(seed).standard_normal((4, 3, 32, 32),
                                                    dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, max_len=MAX_LEN,
        method=jb.Blip2Captioner.generate))(params, x))
    with torch.no_grad():
        got = tm.generate(torch.from_numpy(x), max_len=MAX_LEN).numpy()
        oracle = tm.generate_nocache(torch.from_numpy(x),
                                     max_len=MAX_LEN).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert (got[:, 0] == cfg.opt.bos_token_id).all()
    first_eos = [int(np.argmax(r == eos)) if (r == eos).any() else None
                 for r in got]
    if eos_for is None:
        assert first_eos == [None] * 4
    else:
        # EOS in every row, at more than one step, before the last slot,
        # and latched: every later slot holds EOS
        assert None not in first_eos and len(set(first_eos)) > 1
        assert min(first_eos) < MAX_LEN - 1
        for r, i in zip(got, first_eos):
            assert (r[i:] == eos).all()


def test_vision_routes_to_flash_at_128_tokens(monkeypatch):
    """At 12 x 12 patches + CLS (145 tokens) the vision tower's attention
    takes `flash_attention_fwd` (its plain version on a CPU tensor), the
    Q-Former's 4 queries and the OPT decoder's masked attention do not."""
    tiny = jb.Blip2Config.tiny()
    cfg = dataclasses.replace(
        tiny, vision=dataclasses.replace(tiny.vision, image_size=96))
    jm, params, tm = make_pair(cfg, 5)
    calls = []
    fwd = tattn.flash_attention_fwd

    def spy(q, k, v, **kw):
        calls.append(tuple(q.shape))
        return fwd(q, k, v, **kw)

    monkeypatch.setattr(tattn, "flash_attention_fwd", spy)
    x = images(cfg, 5, b=2)
    ids = np.random.default_rng(5).integers(0, 100, (2, 5)).astype(np.int32)
    want = japply(jm, params, jb.Blip2Captioner.__call__, x, ids)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ids).long())
    assert calls == [(2, 4, 145, 8)] * cfg.vision.layers
    assert rel_err(got, want) < TOL


def test_import_blip2_matches_jax_importer():
    pytest.importorskip("transformers")
    from transformers import (Blip2Config as HFBlip2Config,
                              Blip2ForConditionalGeneration,
                              Blip2QFormerConfig, Blip2VisionConfig,
                              OPTConfig)

    cfg = jb.Blip2Config.tiny()
    hf_cfg = HFBlip2Config.from_vision_qformer_text_configs(
        Blip2VisionConfig(hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          patch_size=8, image_size=32),
        Blip2QFormerConfig(hidden_size=24, num_hidden_layers=2,
                           num_attention_heads=4, intermediate_size=48,
                           cross_attention_frequency=2,
                           encoder_hidden_size=32),
        OPTConfig(hidden_size=40, num_hidden_layers=2, num_attention_heads=4,
                  ffn_dim=80, vocab_size=100, max_position_embeddings=64,
                  do_layer_norm_before=True, word_embed_proj_dim=40),
        num_query_tokens=4)
    torch.manual_seed(0)
    sd = Blip2ForConditionalGeneration(hf_cfg).eval().state_dict()
    want, want_unused = jti.import_blip2(sd, cfg)
    got, unused = tti.import_blip2(sd, port_config(cfg))
    assert unused == want_unused == []
    assert_trees_equal(got, want)
    tm = tb.Blip2Captioner(port_config(cfg), device="cpu")
    assert tti.load_torch_checkpoint(tm, tti.import_blip2, sd,
                                     port_config(cfg)) == []
    torch.testing.assert_close(
        tm.lm.layer_1.fc2.weight,
        sd["language_model.model.decoder.layers.1.fc2.weight"],
        rtol=0, atol=0)


def assert_trees_equal(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], want[k], f"{path}/{k}")


def test_load_torch_checkpoint_refuses_unused_keys():
    cfg = port_config(jb.Blip2Config.tiny())
    tm = tb.Blip2Captioner(cfg, device="cpu")

    def importer(sd, cfg):
        return {}, ["stray.weight"]

    with pytest.raises(ValueError, match="unused"):
        tti.load_torch_checkpoint(tm, importer, {}, cfg)
