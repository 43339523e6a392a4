"""The EulerEDM sampler (sgm-equivalent) and its fast variants.

Counterpart of neurons_tpu/diffusion/samplers.py: `sample_euler` is the
exact deterministic path with s_churn=0 (the unclip6 setting):
d = (x - D(x, sigma)) / sigma, x <- x + (sigma_next - sigma) * d. Sigma
ladders are descending with a trailing 0. The fast variants keep that
step and change what the denoiser computes at each step:

  * `sample_euler_tgate`: TGATE (arXiv 2404.02747) gates the cross
    attention after `gate_step` steps, with an optional PAB phase inside
    the gated steps (`gated_interval`);
  * `sample_euler_pab`: Pyramid Attention Broadcast (arXiv 2408.12588);
  * `sample_euler_encoder_reuse`: encoder-feature propagation ("Faster
    Diffusion", arXiv 2312.09608), also DeepCache's alternation.

Python control flow replaces the JAX package's `lax.scan`/`lax.cond`,
with its step-index arithmetic branch for branch. Where the JAX package
seeds a scan carry with zeros of a cache's shape, the cache here starts
as None: every branch that reads a cache runs after one that wrote it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# denoise(x, sigma_batch) -> denoised x0 estimate (conditioning closed over)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def prepare_noise(x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """x *= sqrt(1 + sigma_0^2)."""
    return x * torch.sqrt(1.0 + sigmas[0] ** 2)


def _bshape(sigma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return sigma.expand(x.shape[0]).to(x.dtype)


def _euler(x, denoised, sigma, sigma_next):
    d = (x - denoised) / torch.clamp(sigma, min=1e-9)
    return x + (sigma_next - sigma) * d


def sample_euler(denoise: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                 prepare: bool = True) -> torch.Tensor:
    if prepare:
        x = prepare_noise(x, sigmas)
    for i in range(sigmas.shape[0] - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        x = _euler(x, denoise(x, _bshape(sigma, x)), sigma, sigma_next)
    return x


def sample_euler_tgate(denoise_full: DenoiseFn, denoise_capture: Callable,
                       denoise_gated: Callable, x: torch.Tensor,
                       sigmas: torch.Tensor, gate_step: int,
                       prepare: bool = True,
                       denoise_gated_capture: Optional[Callable] = None,
                       denoise_gated_reuse: Optional[Callable] = None,
                       gated_interval: int = 0) -> torch.Tensor:
    """Euler with cross-attention gating (TGATE). Once the cross-attention
    outputs are frozen to a cached half-average, CFG's two halves are the
    same, so the gated phase runs one batch with every cross-attention
    site skipped:

      steps [0, m-1):  `denoise_full(x, s)`, CFG over the doubled batch
      step  m-1:       `denoise_capture(x, s) -> (denoised, cache)`
      steps [m, n):    `denoise_gated(x, s, cache)`

    with m = gate_step clamped to [1, n]; m = n is exact Euler. With
    `gated_interval` > 1 the gated phase also broadcasts further attention
    residuals (TGATE x PAB): gated step j recomputes them when
    j % gated_interval == 0 (`denoise_gated_capture(x, s, cache) ->
    (denoised, st)`) and reuses them otherwise
    (`denoise_gated_reuse(x, s, cache, st)`)."""
    if prepare:
        x = prepare_noise(x, sigmas)
    n = sigmas.shape[0] - 1
    m = min(max(int(gate_step), 1), n)
    for i in range(m - 1):
        x = _euler(x, denoise_full(x, _bshape(sigmas[i], x)), sigmas[i],
                   sigmas[i + 1])
    denoised, cache = denoise_capture(x, _bshape(sigmas[m - 1], x))
    x = _euler(x, denoised, sigmas[m - 1], sigmas[m])
    if m >= n:
        return x
    pab = gated_interval > 1 and denoise_gated_capture is not None
    st = None
    for j in range(n - m):
        sigma, sigma_next = sigmas[m + j], sigmas[m + j + 1]
        sb = _bshape(sigma, x)
        if not pab:
            denoised = denoise_gated(x, sb, cache)
        elif j % gated_interval == 0:
            denoised, st = denoise_gated_capture(x, sb, cache)
        else:
            denoised = denoise_gated_reuse(x, sb, cache, st)
        x = _euler(x, denoised, sigma, sigma_next)
    return x


def sample_euler_pab(denoise_pab: Callable, x: torch.Tensor,
                     sigmas: torch.Tensor, intervals,
                     pab_range=None, prepare: bool = True) -> torch.Tensor:
    """Euler with Pyramid Attention Broadcast: `denoise_pab(x, sigma,
    caches, use_x, use_s) -> (denoised, caches)` computes (use_* False) or
    reuses (True) the cross / spatial attention residuals.
    intervals = (i_s, i_x) with i_s | i_x: step i runs in full when
    i % i_x == 0 or i lies outside `pab_range` = (lo, hi); otherwise it
    recomputes the spatial residuals when i % i_s == 0 and reuses both
    caches when not."""
    i_s, i_x = intervals
    if i_x % i_s != 0:
        raise ValueError("pab intervals must nest: i_s | i_x")
    if prepare:
        x = prepare_noise(x, sigmas)
    n = sigmas.shape[0] - 1
    lo, hi = pab_range or (0, n)
    caches = (None, None)
    for i in range(n):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        sb = _bshape(sigma, x)
        full_pred = i % i_x == 0 or i < lo or i >= hi
        if full_pred:
            denoised, caches = denoise_pab(x, sb, caches, False, False)
        elif i % i_s == 0:
            denoised, caches = denoise_pab(x, sb, caches, True, False)
        else:
            denoised, caches = denoise_pab(x, sb, caches, True, True)
        x = _euler(x, denoised, sigma, sigma_next)
    return x


def sample_euler_encoder_reuse(denoise_full: Callable,
                               denoise_cached: Callable,
                               x: torch.Tensor, sigmas: torch.Tensor,
                               reuse: int, prepare: bool = True
                               ) -> torch.Tensor:
    """Euler with encoder-feature propagation: `denoise_full(x, sigma) ->
    (denoised, cache)` runs the whole network on steps i % reuse == 0;
    the others run `denoise_cached(x, sigma, cache) -> denoised`. reuse=1
    is exact Euler."""
    if prepare:
        x = prepare_noise(x, sigmas)
    cache = None
    for i in range(sigmas.shape[0] - 1):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        sb = _bshape(sigma, x)
        if i % reuse == 0:
            denoised, cache = denoise_full(x, sb)
        else:
            denoised = denoise_cached(x, sb, cache)
        x = _euler(x, denoised, sigma, sigma_next)
    return x
