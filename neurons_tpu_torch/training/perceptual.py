"""Perceptual (LPIPS) and PatchGAN discriminator losses.

Counterpart of neurons_tpu/training/perceptual.py (the reference's sgm
autoencoder-training losses: LPIPS over VGG16 features,
NLayerDiscriminator, the hinge and vanilla d-losses,
GeneralLPIPSWithDiscriminator's generator and discriminator halves).
NCHW throughout. LPIPS is frozen: its parameters take no gradient and no
optimizer state, while gradients reach its inputs.

The discriminator's BatchNorm is the port's own `BatchNorm`, flax's
semantics rather than `nn.BatchNorm2d`'s: the running variance takes the
biased batch variance (torch's takes the unbiased one), with flax's
momentum 0.9 (torch's 0.1 in its convention). Train mode normalizes with
the batch statistics and, unless told not to (`update_stats=False`, the
generator pass's discriminator), moves the running ones; eval mode
normalizes with the running ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# VGG16 `features` conv plan: (out_channels, conv indices per LPIPS slice)
_VGG_SLICES = (
    (64, (0, 2)),
    (128, (5, 7)),
    (256, (10, 12, 14)),
    (512, (17, 19, 21)),
    (512, (24, 26, 28)),
)
# channel taps at relu1_2 / relu2_2 / relu3_3 / relu4_3 / relu5_3
LPIPS_CHNS = (64, 128, 256, 512, 512)
# ImageNet shift/scale of the LPIPS ScalingLayer (lpips.py:67-78)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """The five LPIPS taps of torchvision's vgg16.features (reference
    lpips/loss/lpips.py:99-138), NCHW."""

    def __init__(self):
        super().__init__()
        cin = 3
        for ch, idxs in _VGG_SLICES:
            for ci in idxs:
                self.add_module(f"conv_{ci}", nn.Conv2d(cin, ch, 3,
                                                        padding=1))
                cin = ch

    def forward(self, x):
        taps = []
        for si, (_, idxs) in enumerate(_VGG_SLICES):
            if si:
                x = F.max_pool2d(x, 2, 2)
            for ci in idxs:
                x = F.relu(getattr(self, f"conv_{ci}")(x))
            taps.append(x)
        return taps


class LPIPS(nn.Module):
    """Learned perceptual metric (reference lpips/loss/lpips.py:12-64):
    each tap unit-normalized over channels, the squared difference, a 1x1
    head per tap, the spatial mean, summed. Inputs NCHW in [-1, 1];
    returns [B, 1, 1, 1]. Built frozen."""

    def __init__(self):
        super().__init__()
        self.net = VGG16Features()
        for k, ch in enumerate(LPIPS_CHNS):
            self.add_module(f"lin{k}", nn.Conv2d(ch, 1, 1, bias=False))
        self.register_buffer("shift", torch.tensor(_SHIFT)[:, None, None],
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE)[:, None, None],
                             persistent=False)
        self.requires_grad_(False)

    def forward(self, x, y):
        def prep(t):
            return (t - self.shift.to(t.dtype)) / self.scale.to(t.dtype)

        def unit(t):
            return t / (torch.sqrt(torch.sum(t ** 2, dim=1, keepdim=True))
                        + 1e-10)

        fx, fy = self.net(prep(x)), self.net(prep(y))
        val = 0.0
        for k in range(len(LPIPS_CHNS)):
            diff = (unit(fx[k]) - unit(fy[k])) ** 2
            val = val + getattr(self, f"lin{k}")(diff).mean(dim=(2, 3),
                                                            keepdim=True)
        return val


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm over NCHW channels: `weight` and `bias`
    (flax's scale and bias) are parameters, `running_mean` and
    `running_var` (flax's batch_stats mean and var) buffers; momentum 0.9
    in flax's convention, the biased batch variance."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, train: bool = True, update_stats: bool = True):
        if train:
            var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       correction=0)
            if update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1 - m) * mean)
                    self.running_var.mul_(m).add_((1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean[:, None, None]) * mul[:, None, None]
                + self.bias[:, None, None]).to(x.dtype)


class NLayerDiscriminator(nn.Module):
    """Pix2Pix PatchGAN discriminator (reference lpips/model/model.py:
    17-88): 4x4 stride-2 convolutions, BatchNorm, LeakyReLU(0.2),
    one-channel patch logits. Input NCHW. `train` normalizes with batch
    statistics; `update_stats=False` leaves the running ones as they
    were."""

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_layers: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv_0 = nn.Conv2d(input_nc, ndf, 4, 2, 1)
        nf = 1
        for n in range(1, n_layers):
            prev, nf = nf, min(2 ** n, 8)
            self.add_module(f"conv_{n}", nn.Conv2d(ndf * prev, ndf * nf, 4,
                                                   2, 1, bias=False))
            self.add_module(f"bn_{n}", BatchNorm(ndf * nf))
        prev, nf = nf, min(2 ** n_layers, 8)
        self.add_module(f"conv_{n_layers}", nn.Conv2d(ndf * prev, ndf * nf,
                                                      4, 1, 1, bias=False))
        self.add_module(f"bn_{n_layers}", BatchNorm(ndf * nf))
        self.conv_out = nn.Conv2d(ndf * nf, 1, 4, 1, 1)

    def forward(self, x, train: bool = True, update_stats: bool = True):
        h = F.leaky_relu(self.conv_0(x), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv_{n}")(h)
            h = getattr(self, f"bn_{n}")(h, train, update_stats)
            h = F.leaky_relu(h, 0.2)
        return self.conv_out(h)


def hinge_d_loss(logits_real, logits_fake):
    """reference lpips/vqperceptual.py:5-10."""
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real, logits_fake):
    """reference lpips/vqperceptual.py:13-17."""
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def nll_from_rec(rec_loss, logvar, weights=None):
    """reference discriminator_loss.py:294-306: the heteroscedastic NLL
    with a global (optionally learned) log-variance; (nll, weighted nll),
    each summed and divided by the batch."""
    nll = rec_loss / torch.exp(logvar) + logvar
    weighted = nll if weights is None else weights * nll
    return (torch.sum(nll) / nll.shape[0],
            torch.sum(weighted) / weighted.shape[0])


def adaptive_weight(nll_grad_last, g_grad_last, disc_weight: float = 1.0):
    """reference discriminator_loss.py:196-205: the GAN term's weight from
    the gradient-norm ratio at the decoder's last layer, clipped to
    [0, 1e4] and detached."""
    d_weight = (torch.linalg.vector_norm(nll_grad_last)
                / (torch.linalg.vector_norm(g_grad_last) + 1e-4))
    return torch.clamp(d_weight, 0.0, 1e4).detach() * disc_weight


def flatten_video(x):
    """dims=3 handling (discriminator_loss.py:224-228): LPIPS per frame."""
    if x.dim() == 5:  # b c t h w -> (b t) c h w
        b, c, t, h, w = x.shape
        return x.transpose(1, 2).reshape(b * t, c, h, w)
    return x


def generator_loss(inputs, recons, *, lpips_apply: Optional[Callable],
                   disc_apply: Callable, logvar,
                   last_layer: Optional[torch.Tensor] = None,
                   last_layer_grads: Optional[Tuple] = None,
                   perceptual_weight: float = 1.0, disc_factor=1.0,
                   disc_weight: float = 1.0, disc_active: bool = True,
                   regularization_log: Optional[Dict] = None,
                   regularization_weights: Optional[Dict] = None,
                   weights=None) -> Tuple[torch.Tensor, Dict]:
    """Generator half of GeneralLPIPSWithDiscriminator.forward (reference
    discriminator_loss.py:207-274, optimizer_idx=0).

    lpips_apply(x, y) -> [B, 1, 1, 1]; disc_apply(x) -> patch logits. The
    GAN weight is taken from the gradients of the NLL and of the GAN term
    at the decoder's last layer: `last_layer` (the reference's
    `calculate_adaptive_weight`: both by autograd.grad over this forward,
    the graph kept) or `last_layer_grads` = (nll grad, g grad); with
    neither it is 1, the reference's eval behaviour."""
    inputs, recons = flatten_video(inputs), flatten_video(recons)
    rec = torch.abs(inputs - recons)
    if perceptual_weight > 0:
        rec = rec + perceptual_weight * lpips_apply(inputs, recons)
    nll, weighted_nll = nll_from_rec(rec, logvar, weights)
    if disc_active:
        g = -torch.mean(disc_apply(recons))
        if last_layer is not None:
            last_layer_grads = tuple(
                torch.autograd.grad(t, last_layer, retain_graph=True)[0]
                for t in (nll, g))
        d_w = (adaptive_weight(*last_layer_grads, disc_weight)
               if last_layer_grads is not None
               else torch.ones((), device=nll.device))
    else:
        g = d_w = torch.zeros((), device=nll.device)
    loss = weighted_nll + d_w * disc_factor * g
    log = {"loss/nll": nll, "loss/rec": rec.mean(), "loss/g": g,
           "scalars/d_weight": d_w, "scalars/logvar": logvar}
    for k, v in (regularization_log or {}).items():
        w = (regularization_weights or {}).get(k)
        if w is not None:
            loss = loss + w * v
        log[k] = torch.mean(v)
    log["loss/total"] = loss
    return loss, log


def discriminator_loss(inputs, recons, *, disc_apply: Callable,
                       disc_factor=1.0, kind: str = "hinge"
                       ) -> Tuple[torch.Tensor, Dict]:
    """Discriminator half (reference discriminator_loss.py:275-290,
    optimizer_idx=1); inputs and reconstructions are detached."""
    inputs, recons = flatten_video(inputs), flatten_video(recons)
    lr = disc_apply(inputs.detach())
    lf = disc_apply(recons.detach())
    fn = hinge_d_loss if kind == "hinge" else vanilla_d_loss
    d = disc_factor * fn(lr, lf)
    return d, {"loss/disc": d, "logits/real": lr.mean(),
               "logits/fake": lf.mean()}


# the importers live in interop/torch_import.py; aliases for the call
# sites that grew up with this module, as in the JAX package

def import_lpips(state_dict):
    from neurons_tpu_torch.interop.torch_import import import_lpips as _f
    return _f(state_dict)


def import_nlayer_discriminator(state_dict, n_layers: int = 3):
    from neurons_tpu_torch.interop.torch_import import \
        import_nlayer_discriminator as _f
    return _f(state_dict, n_layers)
