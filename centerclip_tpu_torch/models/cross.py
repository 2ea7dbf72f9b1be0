# coding=utf-8
"""Cross-fusion transformer of the `tightTransf` similarity header (port of
the JAX package's `models/cross.py`; reference: modules/module_cross.py:
126-226).

Learned position embeddings over the concatenated [text | video] token
sequence, a small pre-LN transformer with an additive key-padding mask of
-1e6, and a first-token pooler (LayerNorm, dense, QuickGELU).  The blocks
are built with `fused=False` and run in the input's dtype, fp32 in
CLIP4Clip: their attention is the plain fp32 path that the JAX package's
blocks run, because the mask is per sample ([B, 1, 1, L]) and the
attention kernel takes one [L, L] mask (`models/layers.py`).  Their
LayerNorms go through kernels C and D like every other LayerNorm.

`CrossConfig.get_config` resolves the archive name as the JAX package does:
first relative to this module (the port's own `cross-base/`), then through
`utils/file_cache.resolve_archive_dir` (a directory, a `.tar.gz` or a URL).
State-dict names are the reference's: `embeddings.position_embeddings.weight`,
`transformer.resblocks.{i}.*`, `pooler.ln_pool.*`, `pooler.dense.*`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.quick_gelu import quick_gelu_op
from .layers import LayerNormF32, ResidualAttentionBlock, _lecun_normal_

# the additive mask value of a padded key (module_cross.py:205-210)
MASKED = -1000000.0


@dataclass(frozen=True)
class CrossConfig:
    """reference: modules/cross-base/cross_config.json:1-12"""
    hidden_size: int = 512
    num_hidden_layers: int = 4
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 77
    vocab_size: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02

    @classmethod
    def get_config(cls, name_or_path: str = "cross-base", cache_dir=None,
                   **overrides) -> "CrossConfig":
        """The config of a cross-model archive (reference base.py:34-73):
        JSON keys the model does not use are dropped, `overrides` win
        last (the reference's `update_attr`)."""
        from ..utils.file_cache import resolve_archive_dir
        local = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             str(name_or_path))
        target = local if os.path.exists(local) else name_or_path
        directory, tempdir = resolve_archive_dir(target, cache_dir)
        try:
            with open(os.path.join(directory, "cross_config.json")) as f:
                raw = json.load(f)
        finally:
            if tempdir:
                shutil.rmtree(tempdir, ignore_errors=True)
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in raw.items() if k in known}
        kw.update(overrides)
        return cls(**kw)


def key_padding_mask(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] 0/1 -> the additive [B, 1, 1, L] fp32 mask: 0 where a key is
    kept, -1e6 where it is padding."""
    return ((1.0 - mask.float()) * MASKED)[:, None, None, :]


class _Embeddings(nn.Module):
    def __init__(self, max_positions: int, hidden: int):
        super().__init__()
        self.position_embeddings = nn.Embedding(max_positions, hidden)


class _Transformer(nn.Module):
    def __init__(self, hidden: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(hidden, heads, torch.float32, fused=False)
            for _ in range(layers))


class _Pooler(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.ln_pool = LayerNormF32(hidden)
        self.dense = nn.Linear(hidden, hidden)


class CrossModel(nn.Module):
    """Fusion transformer over concatenated text and video features."""

    def __init__(self, cfg: CrossConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.embeddings = _Embeddings(cfg.max_position_embeddings, H)
        self.transformer = _Transformer(H, cfg.num_hidden_layers,
                                        cfg.num_attention_heads)
        self.pooler = _Pooler(H)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's initialisers: positions N(0, initializer_range),
        LeCun-normal dense kernels, zero biases, unit LayerNorms."""
        with torch.no_grad():
            self.embeddings.position_embeddings.weight.normal_(
                0.0, self.cfg.initializer_range, generator=generator)
            dense = self.pooler.dense
            _lecun_normal_(dense.weight, dense.in_features, generator)
            dense.bias.zero_()
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters") \
                    and not isinstance(m, (nn.Linear, nn.Embedding)):
                m.reset_parameters(generator)

    def forward(self, concat_input: torch.Tensor,
                concat_type: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """concat_input [B, L, H]; attention_mask [B, L] 0/1 (None: all
        kept).  `concat_type` is accepted for the reference's signature and
        not read, as in the JAX package.  Returns (hidden [B, L, H], pooled
        [B, H])."""
        del concat_type
        B, L, _ = concat_input.shape
        if attention_mask is None:
            attention_mask = concat_input.new_ones((B, L))
        ext = key_padding_mask(attention_mask)
        pos = self.embeddings.position_embeddings.weight[:L]
        x = concat_input + pos.to(concat_input.dtype)
        for block in self.transformer.resblocks:
            x = block(x, ext)
        pooled = self.pooler.ln_pool(x[:, 0].contiguous())
        dense = self.pooler.dense
        pooled = nn.functional.linear(pooled.float(), dense.weight, dense.bias)
        return x, quick_gelu_op(pooled)
