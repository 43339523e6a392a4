"""The port's T5 v1.1 encoder (models/t5.py) against the JAX package on the
CPU: the relative-position buckets bit for bit for T up to 512, the ByT5
tokenizer, a tiny encoder within 1e-5 * max (f32, every leaf drawn from
numpy), and `import_t5_encoder` against the JAX importer on a synthetic HF
T5EncoderModel state dict written by the port's exporter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neurons_tpu.interop import torch_import as jti
from neurons_tpu.models import t5 as JT
from neurons_tpu_torch.interop import torch_export as tex
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models import t5 as TT
from torch_port_utils import randomize, rel_err

TOL = 1e-5
TINY = dict(vocab_size=64, d_model=32, d_kv=8, d_ff=48, num_layers=2,
            num_heads=4, relative_attention_num_buckets=32,
            relative_attention_max_distance=128)


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (16, 64),
                                                  (64, 256)])
def test_relative_position_bucket_is_bitwise_jax(buckets, max_distance):
    pos = np.arange(512)
    rel = pos[None, :] - pos[:, None]
    want = np.asarray(JT.relative_position_bucket(jnp.asarray(rel), buckets,
                                                  max_distance))
    got = TT.relative_position_bucket(torch.from_numpy(rel), buckets,
                                      max_distance)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # every bucket is reached but the positive side's 0 (no distance 0 > 0)
    assert len(np.unique(want)) == buckets - 1


def test_byt5_tokenize_matches_jax():
    texts = ["a cat", "", "naïve façade — 漢字", "x" * 200]
    for n in (77, 8):
        np.testing.assert_array_equal(TT.byt5_tokenize(texts, n),
                                      JT.byt5_tokenize(texts, n))


def test_configs_match_jax():
    assert TT.t5_v1_1_xxl()._asdict() == JT.t5_v1_1_xxl()._asdict()
    assert TT.byt5_base()._asdict() == JT.byt5_base()._asdict()


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JT.T5Config(**TINY), TT.T5Config(**TINY)
    ids = np.random.default_rng(0).integers(0, 64, (2, 150)).astype(np.int32)
    shapes = jax.eval_shape(JT.T5Encoder(jcfg).init, jax.random.PRNGKey(0),
                            ids)["params"]
    params = randomize(shapes, 1)
    mod = TT.T5Encoder(tcfg, device="cpu")
    load_jax_params(mod, params)
    return jcfg, tcfg, params, mod, ids


def test_tiny_encoder_matches_jax(tiny):
    jcfg, _, params, mod, ids = tiny
    want = np.asarray(jax.jit(lambda p, i: JT.T5Encoder(jcfg).apply(
        {"params": p}, i))(params, ids))
    got = mod(torch.from_numpy(ids))
    assert got.shape == (2, 150, 32)
    assert float(np.abs(want).max()) > 0
    assert rel_err(got, want) <= TOL


def test_jax_tree_names_the_flax_leaves(tiny):
    _, _, params, mod, _ = tiny
    tree = tex.jax_tree(mod)
    assert jax.tree.structure(tree) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_import_t5_encoder_matches_jax(tiny):
    jcfg, tcfg, params, mod, ids = tiny
    sd = tex.to_torch(tex.t5_encoder_state_dict(tex.jax_tree(mod), tcfg))
    want, wunused = jti.import_t5_encoder(sd, jcfg)
    got, unused = TT.import_t5_encoder(sd, tcfg)
    assert unused == wunused == []
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))
    fresh = TT.T5Encoder(tcfg, device="cpu")
    load_jax_params(fresh, got)
    x = torch.from_numpy(ids[:, :20])
    assert torch.equal(fresh(x), mod(x))
