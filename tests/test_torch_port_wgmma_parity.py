"""The plain version of the flash forward (`flash_attention_fwd` on CPU
tensors, what the wgmma kernel is held to on the card) against the JAX
package's `flash_attention`, the Pallas kernels #1/#2 in interpret mode,
at the head dims only the wgmma route's instances launch with column
blocks narrower than 64: d 32 (one 64-byte block), 40 (three of 32 bytes,
zero-filled past 40), 80 (five of 32) and 88 (three of 64, zero-filled
past 88), with and without the log-sum-exp, over ragged rows in the
whole-KV and the streamed-KV regimes.

Tolerance: max |port - JAX| <= 1e-4 * max |JAX| in f32 (both sides run the
same f32 arithmetic up to summation order); the lse within 1e-5 of the
JAX one."""

import numpy as np
import jax.numpy as jnp
import pytest

from neurons_tpu.ops import attention as jattn
from neurons_tpu_torch.ops import attention as tattn
from torch_port_utils import rel_err, t

TOL = 1e-4

# (b, h, tq, tk): whole KV (tk * 4 bytes under the TPU kernel's 4.6 KB a
# row) and one streamed in blocks of 256 keys (d 40: 1300 keys)
CASES = {32: (1, 2, 130, 200), 40: (1, 1, 129, 1300), 80: (2, 1, 150, 140),
         88: (1, 2, 257, 257)}


@pytest.mark.parametrize("lse", [False, True], ids=["out", "lse"])
@pytest.mark.parametrize("d", sorted(CASES))
def test_plain_version_matches_pallas_interpret(d, lse):
    b, h, tq, tk = CASES[d]
    rng = np.random.default_rng(d + tk)
    q, k, v = (rng.standard_normal((b, h, n, d), dtype=np.float32)
               for n in (tq, tk, tk))
    ref = jattn._flash_attention_impl(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), interpret=True,
                                      return_lse=lse)
    got = tattn.flash_attention_fwd(t(q), t(k), t(v), return_lse=lse)
    if lse:
        (ref, ref_lse), (got, got_lse) = ref, got
        assert got_lse.shape == ref_lse.shape
        assert np.abs(got_lse.numpy() - np.asarray(ref_lse)).max() <= 1e-5
    assert got.shape == ref.shape
    assert rel_err(got, ref) <= TOL
