"""Conditioning: the generic embedder registry and the unCLIP instance.

Counterpart of neurons_tpu/models/conditioner.py. `GeneralConditioner` is
sgm's registry: a list of embedders, each declaring its batch input keys,
whose outputs are routed by rank into `vector` (2-d), `crossattn` (3-d) or
`concat` (4/5-d) and concatenated along the slot's axis, with the two
unconditional-guidance dropout flavours: multiplicative Bernoulli zeroing
(`ucg_rate`) and per-example input substitution (`legacy_ucg_val`).
Dropout draws nothing by default (inference); a call drops with explicit
masks (`drops`, so a test can replay the JAX package's draws) or draws
them from `generator`.

The unclip6 engine uses three embedders: the CLIP image tokens ->
crossattn, and ConcatTimestepEmbedderND(256) on the original size and on
the crop coordinates -> vector. `unclip_vector_suffix` is the constant
the reference computes once from a placeholder batch (size 768, crop 0).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from neurons_tpu_torch.models.unet2d import timestep_embedding


@dataclasses.dataclass(frozen=True)
class Embedder:
    """One registry entry.

    fn: `(*batch[k] for k in input_keys) -> tensor | sequence of tensors`.
    ucg_rate: Bernoulli probability of zeroing each example's embedding.
    legacy_ucg_val: when set, dropout replaces the input value instead of
        zeroing the output.
    out_key: overrides the rank-based slot routing.
    """
    fn: Callable[..., Any]
    input_keys: Tuple[str, ...]
    ucg_rate: float = 0.0
    legacy_ucg_val: Optional[Any] = None
    out_key: Optional[str] = None


class GeneralConditioner:
    """Rank-routing embedder registry."""

    OUTPUT_DIM2KEYS = {2: "vector", 3: "crossattn", 4: "concat", 5: "concat"}
    KEY2CATDIM = {"vector": 1, "crossattn": 2, "concat": 1}

    def __init__(self, embedders: Sequence[Embedder]):
        self.embedders = tuple(embedders)

    def _drop(self, i: int, e: Embedder, rows: int, device, drops,
              generator) -> Optional[torch.Tensor]:
        """Embedder i's dropout mask [rows] (True = drop), or None."""
        if e.ucg_rate <= 0.0:
            return None
        if drops is not None:
            return drops[i].to(device, torch.bool) if i in drops else None
        if generator is None:
            return None
        return torch.rand((rows,), generator=generator,
                          device=generator.device).to(device) < e.ucg_rate

    def __call__(self, batch: Mapping[str, torch.Tensor],
                 drops: Optional[Mapping[int, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 force_zero_embeddings: Sequence[str] = ()
                 ) -> Dict[str, torch.Tensor]:
        """Without `drops` and `generator` nothing is dropped (inference).
        `drops` maps an embedder's index to its mask [B] (True = drop);
        otherwise `generator` draws one mask an embedder, shared by its
        outputs."""
        out: Dict[str, torch.Tensor] = {}
        for i, e in enumerate(self.embedders):
            vals = [batch[k] for k in e.input_keys]
            drop = self._drop(i, e, vals[0].shape[0], vals[0].device, drops,
                              generator)
            if e.legacy_ucg_val is not None and drop is not None:
                v0 = vals[0]
                sub = torch.as_tensor(e.legacy_ucg_val, dtype=v0.dtype,
                                      device=v0.device).expand_as(v0)
                vals[0] = torch.where(
                    drop.reshape((-1,) + (1,) * (v0.dim() - 1)), sub, v0)
            emb_out = e.fn(*vals)
            if not isinstance(emb_out, (list, tuple)):
                emb_out = [emb_out]
            for emb in emb_out:
                out_key = e.out_key or self.OUTPUT_DIM2KEYS[emb.dim()]
                if e.legacy_ucg_val is None and drop is not None:
                    keep = (~drop).to(emb.dtype)
                    emb = emb * keep.reshape((-1,) + (1,) * (emb.dim() - 1))
                if e.input_keys and e.input_keys[0] in force_zero_embeddings:
                    emb = torch.zeros_like(emb)
                if out_key in out:
                    out[out_key] = torch.cat(
                        [out[out_key], emb], dim=self.KEY2CATDIM[out_key])
                else:
                    out[out_key] = emb
        return out

    def get_unconditional_conditioning(
        self, batch_c: Mapping[str, torch.Tensor],
        batch_uc: Optional[Mapping[str, torch.Tensor]] = None,
        force_uc_zero_embeddings: Sequence[str] = (),
        force_cond_zero_embeddings: Sequence[str] = (),
    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """The CFG pair (c, uc), without dropout."""
        c = self(batch_c, force_zero_embeddings=force_cond_zero_embeddings)
        uc = self(batch_c if batch_uc is None else batch_uc,
                  force_zero_embeddings=force_uc_zero_embeddings)
        return c, uc


def concat_timestep_embedder(values: torch.Tensor, outdim: int = 256
                             ) -> torch.Tensor:
    """ConcatTimestepEmbedderND: each scalar through the OpenAI timestep
    embedding, concatenated. values [B, N] -> [B, N * outdim], f32."""
    b, n = values.shape
    return timestep_embedding(values.reshape(-1), outdim).reshape(
        b, n * outdim)


def unclip_conditioner(clip_image_fn: Callable[[torch.Tensor], torch.Tensor],
                       outdim: int = 256) -> GeneralConditioner:
    """The unclip6 engine's registry: image tokens -> crossattn (ucg 0.1),
    two ConcatTimestepEmbedderND -> vector."""
    return GeneralConditioner([
        Embedder(clip_image_fn, ("jpg",), ucg_rate=0.1),
        Embedder(lambda v: concat_timestep_embedder(v, outdim),
                 ("original_size_as_tuple",)),
        Embedder(lambda v: concat_timestep_embedder(v, outdim),
                 ("crop_coords_top_left",)),
    ])


def unclip_vector_suffix(batch_size: int = 1,
                         orig_size: Sequence[int] = (768, 768),
                         crop_coords: Sequence[int] = (0, 0),
                         outdim: int = 256, device="cpu") -> torch.Tensor:
    """The constant `vector` conditioning of the unclip engine:
    cat(embed(orig_size), embed(crop)) -> [B, 4 * outdim]."""
    def rows(values):
        return torch.tensor([values], dtype=torch.float32,
                            device=device).repeat(batch_size, 1)
    return torch.cat([concat_timestep_embedder(rows(orig_size), outdim),
                      concat_timestep_embedder(rows(crop_coords), outdim)],
                     dim=-1)
