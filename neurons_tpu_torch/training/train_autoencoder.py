"""AutoencodingEngine: VAE / VQGAN training with LPIPS and a PatchGAN.

Counterpart of neurons_tpu/training/train_autoencoder.py (the reference's
sgm `AutoencodingEngine` with GeneralLPIPSWithDiscriminator: encoder and
decoder with a pluggable regularizer, two optimizers alternating a
generator and a discriminator step, the adaptive GAN weight at the
decoder's last layer).

The JAX package's two jitted steps over a state pytree become two
callables over an `AutoencoderState` (the VAE, the optional quantizer, the
discriminator with its running statistics, the optional learned logvar,
the two Adam optimizers and the step counter), updated in place:

- Adam is optax.adam(lr, b1=0.5, b2=0.9): eps 1e-8 outside the square
  root, bias correction, no weight decay, which is torch.optim.Adam's
  formula. Every parameter of an optimizer gets a gradient every step (a
  zero where it has none), as optax's tree does.
- Before `disc_start`, the discriminator step multiplies its gradients by
  0 and still steps Adam (its count advances); the generator step scales
  the GAN term by the same gate and still computes d_weight.
- d_weight: JAX takes jax.grad of the NLL and of the GAN term at
  decoder.conv_out by recomputing the reconstruction twice with the same
  key; the port takes torch.autograd.grad of both at
  `decoder.conv_out.weight` over its one forward, as the reference's
  calculate_adaptive_weight does (the norms do not depend on the layout).
- The generator pass runs the discriminator in train mode on batch
  statistics and leaves its running statistics as they were; only the
  generator's parameters are differentiated (LPIPS is frozen, the
  discriminator takes no gradient from it). The discriminator step runs
  the reconstruction under no_grad and threads the running statistics
  through the real pass, then the fake pass.
- The KL posterior samples explicit noise (or a draw of a generator) in
  place of JAX's key; "vq" quantizes the posterior mean.

Under autograd the VAE's mid-block attention (one head, d 512 at full
width) takes the differentiable flash path (ops/attention.py): the forward
with lse and the backward kernel on the card; the discriminator step's
no-grad reconstruction takes the plain forward kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from neurons_tpu_torch import resolve_device
from neurons_tpu_torch.config import VAEConfig
from neurons_tpu_torch.interop.from_jax import load_jax_params
from neurons_tpu_torch.models.vae import AutoencoderKL
from neurons_tpu_torch.models.vq import (VectorQuantizer, kl_to_standard,
                                         sample_posterior)
from neurons_tpu_torch.training.perceptual import (LPIPS, NLayerDiscriminator,
                                                   discriminator_loss,
                                                   generator_loss)


@dataclass
class AutoencoderTrainConfig:
    """The knobs of GeneralLPIPSWithDiscriminator and the engine
    (reference discriminator_loss.py:18-34, autoencoder.py:109-168)."""

    vae: VAEConfig = field(default_factory=VAEConfig)
    regularizer: str = "kl"  # kl | vq | none
    n_codes: int = 8192  # vq only
    codebook_beta: float = 0.25
    kl_weight: float = 1e-6
    perceptual_weight: float = 1.0
    disc_start: int = 50001
    disc_factor: float = 1.0
    disc_weight: float = 0.5
    disc_num_layers: int = 3
    disc_ndf: int = 64
    disc_loss: str = "hinge"
    learn_logvar: bool = False
    lr: float = 4.5e-6


@dataclass
class AutoencoderState:
    """The trainer's state; the steps update it in place."""

    vae: AutoencoderKL
    disc: NLayerDiscriminator
    logvar: torch.Tensor
    opt_g: torch.optim.Adam
    opt_d: torch.optim.Adam
    quant: Optional[VectorQuantizer] = None
    step: int = 0

    def gen_params(self) -> List[torch.Tensor]:
        """The generator optimizer's parameters: the VAE's, the
        quantizer's, the logvar when it is learned."""
        return [p for g in self.opt_g.param_groups for p in g["params"]]


def _adam(params, lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8)


def _apply(opt: torch.optim.Optimizer, params: List[torch.Tensor],
           grads, scale: float = 1.0):
    """Step `opt` on `grads` (None -> zeros, as optax's gradient tree
    holds a zero there), each times `scale`, then clear them."""
    for p, g in zip(params, grads):
        g = torch.zeros_like(p) if g is None else g
        p.grad = g * scale if scale != 1.0 else g
    opt.step()
    for p in params:
        p.grad = None


class AutoencodingEngine:
    """Builds the modules and makes the two steps. `lpips_params`: LPIPS's
    flax-layout tree (`import_lpips` of a `vgg_lpips` checkpoint); None
    draws random LPIPS weights, as the JAX package's init does."""

    def __init__(self, cfg: AutoencoderTrainConfig,
                 lpips_params: Optional[Mapping] = None):
        self.cfg = cfg
        self.lpips_params = lpips_params
        self.lpips: Optional[LPIPS] = None
        self.reg_weights = ({"kl_loss": cfg.kl_weight}
                            if cfg.regularizer == "kl"
                            else {"loss/vq": 1.0} if cfg.regularizer == "vq"
                            else {})

    def init(self, device="cuda") -> AutoencoderState:
        """Every module on `device` (the card by default), drawn from
        torch's global generator."""
        c = self.cfg
        dev = resolve_device(device)
        vae = AutoencoderKL(c.vae, device=dev)
        with torch.device(dev):
            disc = NLayerDiscriminator(c.vae.out_channels, c.disc_ndf,
                                       c.disc_num_layers)
            quant = (VectorQuantizer(c.n_codes, c.vae.latent_channels,
                                     c.codebook_beta)
                     if c.regularizer == "vq" else None)
            if c.perceptual_weight > 0:
                self.lpips = LPIPS()
                if self.lpips_params is not None:
                    load_jax_params(self.lpips, self.lpips_params)
            logvar = torch.zeros((), requires_grad=c.learn_logvar)
        gen = list(vae.parameters())
        if quant is not None:
            gen += list(quant.parameters())
        if c.learn_logvar:
            gen.append(logvar)
        return AutoencoderState(vae=vae, disc=disc, logvar=logvar,
                                opt_g=_adam(gen, c.lr),
                                opt_d=_adam(list(disc.parameters()), c.lr),
                                quant=quant)

    # ---- forward --------------------------------------------------------

    def encode_reg(self, state: AutoencoderState, x: torch.Tensor,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Encode and regularize (reference autoencoder.py:196-208): the KL
        posterior sampled from `noise` (or a draw of `generator`; neither:
        its mode) with its KL; "vq" quantizes the posterior mean."""
        post = state.vae.encode(x)
        reg_log: Dict[str, torch.Tensor] = {}
        if self.cfg.regularizer == "kl":
            z = sample_posterior(post.mean, post.logvar, noise, generator)
            reg_log["kl_loss"] = kl_to_standard(post.mean, post.logvar)
        else:
            z = post.mean
            if state.quant is not None:
                z, qlog = state.quant(z)
                reg_log["loss/vq"] = qlog["loss/vq"]
        return z, reg_log

    def reconstruct(self, state: AutoencoderState, x: torch.Tensor,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        z, reg_log = self.encode_reg(state, x, noise, generator)
        return state.vae.decode(z), reg_log

    # ---- steps ----------------------------------------------------------

    def make_generator_step(self) -> Callable:
        """step(state, x, noise=None, generator=None) -> (state, loss, log):
        one Adam step of the VAE (and the quantizer, and the logvar when
        learned) on the generator loss; the step counter advances."""
        c = self.cfg

        def step(state: AutoencoderState, x: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
            gate = 1.0 if state.step >= c.disc_start else 0.0
            params = state.gen_params()
            recon, reg_log = self.reconstruct(state, x, noise, generator)

            def disc_apply(y):
                return state.disc(y, train=True, update_stats=False)

            loss, log = generator_loss(
                x, recon, lpips_apply=self.lpips,
                disc_apply=disc_apply, logvar=state.logvar,
                last_layer=state.vae.decoder.conv_out.weight,
                perceptual_weight=c.perceptual_weight,
                disc_factor=c.disc_factor * gate,
                disc_weight=c.disc_weight, regularization_log=reg_log,
                regularization_weights=self.reg_weights)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            _apply(state.opt_g, params, grads)
            state.step += 1
            return state, loss.detach(), {k: v.detach()
                                          for k, v in log.items()}

        return step

    def make_discriminator_step(self) -> Callable:
        """step(state, x, noise=None, generator=None) -> (state, loss, log):
        one Adam step of the discriminator on the hinge (or vanilla) loss;
        its gradients are multiplied by 0 before `disc_start`."""
        c = self.cfg

        def step(state: AutoencoderState, x: torch.Tensor,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
            with torch.no_grad():
                recon, _ = self.reconstruct(state, x, noise, generator)
            params = list(state.disc.parameters())
            d, log = discriminator_loss(
                x, recon, disc_apply=lambda y: state.disc(y, train=True),
                disc_factor=c.disc_factor, kind=c.disc_loss)
            grads = torch.autograd.grad(d, params, allow_unused=True)
            gate = 1.0 if state.step >= c.disc_start else 0.0
            _apply(state.opt_d, params, grads, gate)
            return state, d.detach(), {k: v.detach() for k, v in log.items()}

        return step


def adam_count(opt: torch.optim.Optimizer) -> int:
    """The steps an optimizer has taken (optax's ScaleByAdamState.count)."""
    p = opt.param_groups[0]["params"][0]
    return int(opt.state[p]["step"]) if p in opt.state else 0
