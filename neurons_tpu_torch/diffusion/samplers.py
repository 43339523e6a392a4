"""The sgm sampler set (EulerEDM, Heun, Euler ancestral, DPM++(2S)
ancestral, DPM++(2M), linear multistep), the guiders that wrap a
denoiser, and the EulerEDM fast variants.

Counterpart of neurons_tpu/diffusion/samplers.py. Sigma ladders are
descending with a trailing 0, and `prepare` multiplies the start by
sqrt(1 + sigma_0^2). `sample_euler` with s_churn=0 (the unclip6 setting)
is the deterministic step d = (x - D(x, sigma)) / sigma,
x <- x + (sigma_next - sigma) * d. The fast variants keep that step and
change what the denoiser computes at each step:

  * `sample_euler_tgate`: TGATE (arXiv 2404.02747) gates the cross
    attention after `gate_step` steps, with an optional PAB phase inside
    the gated steps (`gated_interval`);
  * `sample_euler_pab`: Pyramid Attention Broadcast (arXiv 2408.12588);
  * `sample_euler_encoder_reuse`: encoder-feature propagation ("Faster
    Diffusion", arXiv 2312.09608), also DeepCache's alternation.

Python control flow replaces the JAX package's `lax.scan`/`lax.cond`,
with its step-index arithmetic branch for branch. Where the JAX package
decides on traced sigmas (Heun's correction at sigma_next > 0, DPM++(2S)'s
midpoint at sigma_down > 1e-10, DPM++(2M)'s first and last steps), the
samplers here decide on the ladder copied to the host once, in f32 as JAX
computes it, so no step waits for the card. The stochastic samplers take
step i's noise as `noise[i]` (explicit tensors, so a test can replay the
JAX package's `fold_in(key, i)` draws) or draw it from `generator`. Where
the JAX package seeds a scan carry with zeros of a cache's shape, the
cache here starts as None: every branch that reads a cache runs after one
that wrote it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

# denoise(x, sigma_batch) -> denoised x0 estimate (conditioning closed over)
DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _uncond_cond(denoiser, network, cond: Dict, uc: Dict, x, sigma):
    """The denoiser on [uncond ++ cond] in one doubled batch: (x_u, x_c)."""
    c2 = {k: torch.cat([uc[k], cond[k]]) for k in cond}
    return denoiser(network, torch.cat([x, x]), torch.cat([sigma, sigma]),
                    **c2).chunk(2)


def make_cfg_denoiser(denoiser, network, cond: Dict, uc: Dict,
                      scale: float) -> DenoiseFn:
    """VanillaCFG: x_u + scale * (x_c - x_u)."""

    def denoise(x, sigma):
        x_u, x_c = _uncond_cond(denoiser, network, cond, uc, x, sigma)
        return x_u + scale * (x_c - x_u)

    return denoise


def make_identity_denoiser(denoiser, network, cond: Dict) -> DenoiseFn:
    def denoise(x, sigma):
        return denoiser(network, x, sigma, **cond)

    return denoise


def make_linear_prediction_denoiser(denoiser, network, cond: Dict, uc: Dict,
                                    num_frames: int, min_scale: float = 1.0,
                                    max_scale: float = 2.5) -> DenoiseFn:
    """LinearPredictionGuider (SVD's video CFG): a per-frame guidance scale
    ramping linearly min -> max over the clip; the frames are folded into
    the batch, [(B F), ...]."""
    scales = torch.linspace(min_scale, max_scale, num_frames)

    def denoise(x, sigma):
        x_u, x_c = _uncond_cond(denoiser, network, cond, uc, x, sigma)
        scale = scales.to(x_u.device, x_u.dtype).repeat(
            x_u.shape[0] // num_frames)
        scale = scale.reshape((-1,) + (1,) * (x_u.dim() - 1))
        return x_u + scale * (x_c - x_u)

    return denoise


def prepare_noise(x: torch.Tensor, sigmas: torch.Tensor) -> torch.Tensor:
    """x *= sqrt(1 + sigma_0^2)."""
    return x * torch.sqrt(1.0 + sigmas[0] ** 2)


def _bshape(sigma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return sigma.expand(x.shape[0]).to(x.dtype)


def _host(sigmas) -> torch.Tensor:
    """The ladder on the host in f32: its entries are 0-d CPU tensors, so
    the scalar arithmetic is JAX's f32 and a branch on it waits for no
    device."""
    return torch.as_tensor(sigmas).detach().to("cpu", torch.float32)


def _full(sigma: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A host sigma as the denoiser's per-row sigma batch on x's device."""
    return torch.full((x.shape[0],), float(sigma), dtype=x.dtype,
                      device=x.device)


def _draw(noise: Optional[Sequence[torch.Tensor]], generator, i: int,
          x: torch.Tensor) -> torch.Tensor:
    """Step i's standard normal draw of x's shape: noise[i] if given, else
    from `generator`."""
    if noise is not None:
        return noise[i].to(x.device, x.dtype)
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def _euler(x, denoised, sigma, sigma_next):
    d = (x - denoised) / torch.clamp(sigma, min=1e-9)
    return x + (sigma_next - sigma) * d


def sample_euler(denoise: DenoiseFn, x: torch.Tensor, sigmas: torch.Tensor,
                 prepare: bool = True, s_churn: float = 0.0,
                 s_noise: float = 1.0,
                 noise: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """EulerEDM. With s_churn > 0 each step first raises sigma to
    sigma_hat = sigma * (1 + gamma), gamma = min(s_churn / n, sqrt(2) - 1)
    where sigma > 0, adding noise of std sqrt(sigma_hat^2 - sigma^2) (step
    i's draw times s_noise); s_churn = 0 draws nothing."""
    if prepare:
        x = prepare_noise(x, sigmas)
    n = sigmas.shape[0] - 1
    gamma_max = min(s_churn / max(n, 1), 2 ** 0.5 - 1) if s_churn > 0 else 0.0
    for i in range(n):
        sigma, sigma_next = sigmas[i], sigmas[i + 1]
        if gamma_max > 0.0:
            gamma = torch.where(sigma > 0, gamma_max, 0.0)
            sigma_hat = sigma * (gamma + 1.0)
            eps = _draw(noise, generator, i, x) * s_noise
            x = x + eps * torch.sqrt(torch.clamp(
                sigma_hat ** 2 - sigma ** 2, min=0.0))
        else:
            sigma_hat = sigma
        x = _euler(x, denoise(x, _bshape(sigma_hat, x)), sigma_hat,
                   sigma_next)
    return x


def sample_heun(denoise: DenoiseFn, x: torch.Tensor, sigmas,
                prepare: bool = True) -> torch.Tensor:
    """HeunEDM: an Euler step, then the 2nd-order correction (a second
    denoiser call at sigma_next) where sigma_next > 0."""
    sig = _host(sigmas)
    if prepare:
        x = prepare_noise(x, sig)
    for i in range(sig.shape[0] - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        denoised = denoise(x, _full(sigma, x))
        d = (x - denoised) / torch.clamp(sigma, min=1e-9)
        dt = sigma_next - sigma
        x_euler = x + dt * d
        if sigma_next > 0:
            denoised2 = denoise(x_euler, _full(sigma_next, x))
            d2 = (x_euler - denoised2) / torch.clamp(sigma_next, min=1e-9)
            x = x + dt * 0.5 * (d + d2)
        else:
            x = x_euler
    return x


def _ancestral_step(sigma, sigma_next, eta: float):
    """(sigma_up, sigma_down) of an ancestral step."""
    sigma_up = torch.minimum(sigma_next, eta * torch.sqrt(torch.clamp(
        sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2)
        / torch.clamp(sigma ** 2, min=1e-12), min=0.0)))
    sigma_down = torch.sqrt(torch.clamp(sigma_next ** 2 - sigma_up ** 2,
                                        min=0.0))
    return sigma_up, sigma_down


def sample_euler_ancestral(denoise: DenoiseFn, x: torch.Tensor, sigmas,
                           eta: float = 1.0, s_noise: float = 1.0,
                           prepare: bool = True,
                           noise: Optional[Sequence[torch.Tensor]] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
    """EulerAncestral: an Euler step to sigma_down, then step i's noise
    times s_noise * sigma_up where sigma_next > 0."""
    sig = _host(sigmas)
    if prepare:
        x = prepare_noise(x, sig)
    for i in range(sig.shape[0] - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        sigma_up, sigma_down = _ancestral_step(sigma, sigma_next, eta)
        denoised = denoise(x, _full(sigma, x))
        d = (x - denoised) / torch.clamp(sigma, min=1e-9)
        x = x + (sigma_down - sigma) * d
        if sigma_next > 0:
            x = x + _draw(noise, generator, i, x) * s_noise * sigma_up
    return x


def _t_of(sigma):
    return -torch.log(torch.clamp(sigma, min=1e-10))


def sample_dpmpp2m(denoise: DenoiseFn, x: torch.Tensor, sigmas,
                   prepare: bool = True) -> torch.Tensor:
    """DPM++(2M): multistep in log-sigma space on the previous step's
    denoised estimate (first order at the first step); the last step
    (sigma_next = 0) returns the denoised estimate."""
    sig = _host(sigmas)
    if prepare:
        x = prepare_noise(x, sig)
    old_denoised = None
    for i in range(sig.shape[0] - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        sigma_prev = sig[max(i - 1, 0)]
        denoised = denoise(x, _full(sigma, x))
        t, t_next = _t_of(sigma), _t_of(sigma_next)
        h = t_next - t
        h_last = t - _t_of(sigma_prev)
        r = h_last / (h if h != 0 else 1.0)
        if i > 0 and torch.abs(r) > 1e-9:
            denoised_d = ((1 + 1 / (2 * r)) * denoised
                          - (1 / (2 * r)) * old_denoised)
        else:
            denoised_d = denoised
        if sigma_next > 0:
            x = (sigma_next / torch.clamp(sigma, min=1e-10)) * x \
                - torch.expm1(-h) * denoised_d
        else:
            x = denoised
        old_denoised = denoised
    return x


def sample_dpmpp2s_ancestral(denoise: DenoiseFn, x: torch.Tensor, sigmas,
                             eta: float = 1.0, s_noise: float = 1.0,
                             prepare: bool = True,
                             noise: Optional[Sequence[torch.Tensor]] = None,
                             generator: Optional[torch.Generator] = None
                             ) -> torch.Tensor:
    """DPM++(2S) ancestral: a single-step 2nd-order midpoint in log-sigma
    space to sigma_down (an Euler step where sigma_down <= 1e-10), then
    step i's noise times s_noise * sigma_up where sigma_next > 0."""
    sig = _host(sigmas)
    if prepare:
        x = prepare_noise(x, sig)
    for i in range(sig.shape[0] - 1):
        sigma, sigma_next = sig[i], sig[i + 1]
        sigma_up, sigma_down = _ancestral_step(sigma, sigma_next, eta)
        denoised = denoise(x, _full(sigma, x))
        if sigma_down > 1e-10:
            t, t_next = _t_of(sigma), _t_of(sigma_down)
            h = t_next - t
            s_mid = torch.exp(-(t + 0.5 * h))
            x2 = (s_mid / torch.clamp(sigma, min=1e-10)) * x \
                - torch.expm1(-0.5 * h) * denoised
            denoised2 = denoise(x2, _full(s_mid, x))
            x_new = (torch.exp(-t_next) / torch.clamp(sigma, min=1e-10)) * x \
                - torch.expm1(-h) * denoised2
        else:
            d = (x - denoised) / torch.clamp(sigma, min=1e-9)
            x_new = x + (sigma_down - sigma) * d
        if sigma_next > 0:
            x_new = x_new + _draw(noise, generator, i, x) * s_noise * sigma_up
        x = x_new
    return x


def _lms_coefficients(sigmas, order: int) -> np.ndarray:
    """Adams-Bashforth coefficients per step: each Lagrange basis
    polynomial over the last min(i + 1, order) sigmas, integrated over
    [sigma_i, sigma_{i+1}] by the trapezoid rule on 1025 points (written
    out, as numpy.trapezoid, which older numpy lacks, computes it)."""
    sig = np.asarray(sigmas, np.float64)
    n = len(sig) - 1
    coeffs = np.zeros((n, order), np.float64)
    for i in range(n):
        cur = min(i + 1, order)
        ts = np.linspace(sig[i], sig[i + 1], 1025)
        for j in range(cur):
            prod = np.ones_like(ts)
            for k in range(cur):
                if k == j:
                    continue
                prod *= (ts - sig[i - k]) / (sig[i - j] - sig[i - k])
            coeffs[i, j] = (np.diff(ts) * (prod[1:] + prod[:-1]) / 2.0).sum()
    return coeffs


def sample_lms(denoise: DenoiseFn, x: torch.Tensor, sigmas,
               order: int = 4, prepare: bool = True) -> torch.Tensor:
    """Linear multistep: Adams-Bashforth over the last `order` derivative
    estimates, the coefficients computed on the host ladder."""
    sig = _host(sigmas)
    coeffs = _lms_coefficients(sig.numpy(), order).astype(np.float32)
    if prepare:
        x = prepare_noise(x, sig)
    ds = []  # newest first
    for i in range(sig.shape[0] - 1):
        sigma = sig[i]
        denoised = denoise(x, _full(sigma, x))
        ds = [(x - denoised) / torch.clamp(sigma, min=1e-9)] + ds[:order - 1]
        upd = float(coeffs[i, 0]) * ds[0]
        for j in range(1, len(ds)):
            upd = upd + float(coeffs[i, j]) * ds[j]
        x = x + upd
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
