"""CLIP4Clip with meanP and kmediods++ or spectral token clustering, in plain
PyTorch.

Written from the published descriptions (CLIP, Radford et al. 2021; CLIP4Clip
meanP; CenterCLIP's multi-segment k-medoids, Zhao et al. 2022), on a flat
dict of fp32 weights under CLIP's state-dict names (prefixed `clip.`), with
no kernel, cache or batching of the program's:

* vision: frames normalised by CLIP's pixel statistics, cut into P x P
  patches and projected, CLS and positions added, `ln_pre`; before each
  block that the cluster plan names, each segment's dur x P patch tokens
  are clustered by k-medoids (KKZ seeds, Lloyd steps to the fixed point,
  medoid ids sorted), or with the plan's `spectral` by k-medoids on their
  spectral embedding (`spectral.py`), and replaced by their K medoids, the
  segment's CLS by
  the mean of its frames' CLS; pre-LN blocks (softmax attention, MLP with
  QuickGELU); `ln_post` on CLS, projection;
* text: token and position embeddings, causal blocks, `ln_final`, the EOT
  position (the largest id), projection;
* meanP: frame features normalised, averaged over the (post-cluster)
  frames, normalised; logits exp(logit_scale) t.v^T; the loss is the mean
  of the two InfoNCE directions.

k-medoids works on the tokens in fp32: Euclidean distances from the
mean-centred Gram matrix, shifted per segment below zero, less 1 on the
diagonal; KKZ starts at the largest-norm token and adds the token
farthest from its nearest medoid; a Lloyd step assigns every token to its
nearest medoid and moves each medoid to the member with the least
summed distance to the others; first index on every tie.

Every matmul goes through `Numerics.mm`: exact fp32 (TF32 off) for the
reference, or its operands rounded to fp8 (e4m3 forward, e5m2 for the
gradients flowing back, each scaled by its tensor's largest magnitude)
for the control, the reference one precision below the program's bf16;
"fp8_vision" rounds the vision tower's operands alone (the text tower's
stay exact), a control of the layers that only the vision tower runs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.nn import functional as F

from . import spectral

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LN_EPS = 1e-5


def strict_fp32() -> None:
    """No TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Numerics:
    """How matmul operands are rounded: "fp32" (not at all), "fp8", or
    "fp8_vision" (fp8 in the vision tower, fp32 in the text tower)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "fp8_vision"):
            raise ValueError(precision)
        self.precision = precision

    def text(self) -> "Numerics":
        """The numerics of the text tower."""
        return Numerics("fp32") if self.precision == "fp8_vision" else self

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.precision == "fp32" else _Fp8Round.apply(x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.cast(a) @ self.cast(b)

    def linear(self, x, w, b=None):
        y = self.mm(x, w.t())
        return y if b is None else y + b


def parts(name: str, t: torch.Tensor):
    """A leaf as the comparison counts it: CLIP's packed q, k, v
    projections (`in_proj_weight`, `in_proj_bias`) as three, since the key
    bias's gradient is nought under softmax while the query's and value's
    are not."""
    if name.endswith(("in_proj_weight", "in_proj_bias")):
        n = t.shape[0] // 3
        return [(f"{name}[{p}]", t[i * n:(i + 1) * n])
                for i, p in enumerate("qkv")]
    return [(name, t)]


@torch.no_grad()
def part_norms(named) -> Dict[str, float]:
    """{part: L2 norm} of (name, tensor) pairs."""
    return {pn: float(torch.linalg.vector_norm(pt.float()))
            for n, t in named for pn, pt in parts(n, t)}


def layer_norm(x, w, b):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).pow(2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * w + b


def attention(x, W, p, heads, mask, num: Numerics):
    B, L, D = x.shape
    hd = D // heads
    qkv = num.linear(x, W[p + "attn.in_proj_weight"],
                     W[p + "attn.in_proj_bias"])
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    logits = num.mm(q * hd ** -0.5, k.transpose(-1, -2))
    if mask is not None:
        logits = logits + mask
    out = num.mm(torch.softmax(logits, dim=-1), v)
    out = out.transpose(1, 2).reshape(B, L, D)
    return num.linear(out, W[p + "attn.out_proj.weight"],
                      W[p + "attn.out_proj.bias"])


def block(x, W, p, heads, mask, num: Numerics):
    x = x + attention(layer_norm(x, W[p + "ln_1.weight"], W[p + "ln_1.bias"]),
                      W, p, heads, mask, num)
    h = layer_norm(x, W[p + "ln_2.weight"], W[p + "ln_2.bias"])
    h = num.linear(h, W[p + "mlp.c_fc.weight"], W[p + "mlp.c_fc.bias"])
    h = h * torch.sigmoid(1.702 * h)
    return x + num.linear(h, W[p + "mlp.c_proj.weight"],
                          W[p + "mlp.c_proj.bias"])


# ---------------------------------------------------------------- k-medoids
def distances(X: torch.Tensor) -> torch.Tensor:
    """[B, N, Dm] fp32 -> [B, N, N]: Euclidean, shifted below zero per
    segment, 1 less on the diagonal."""
    Xc = X - X.mean(dim=1, keepdim=True)
    sq = (Xc * Xc).sum(-1, keepdim=True)
    d2 = (sq + sq.transpose(1, 2)) - 2.0 * (Xc @ Xc.transpose(1, 2))
    d = d2.clamp_min(0.0).sqrt()
    d = d - d.amax(dim=(1, 2), keepdim=True) - 1.0
    return d - torch.eye(X.shape[1], dtype=d.dtype, device=d.device)


def _rows(D, idx):
    return torch.gather(D, 1, idx[..., None].expand(-1, -1, D.shape[-1]))


@torch.no_grad()
def kmedoids(X: torch.Tensor, K: int, iter_limit: int = 100) -> torch.Tensor:
    """[B, N, Dm] tokens -> [B, K] medoid ids, sorted, at each segment's
    fixed point (or after `iter_limit` Lloyd steps)."""
    X = X.float()
    D = distances(X)
    B = X.shape[0]
    meds = torch.zeros((B, K), dtype=torch.long, device=X.device)
    cur = torch.linalg.vector_norm(X, dim=-1).argmax(dim=1)
    meds[:, 0] = cur
    mind = _rows(D, cur[:, None])[:, 0]
    for i in range(1, K):
        cur = mind.argmax(dim=1)
        meds[:, i] = cur
        mind = torch.minimum(mind, _rows(D, cur[:, None])[:, 0])
    for _ in range(iter_limit):
        assign = _rows(D, meds).argmin(dim=1)                  # [B, N]
        onehot = F.one_hot(assign, K).to(D.dtype)              # [B, N, K]
        new = ((D @ onehot) * onehot).argmin(dim=1)            # [B, K]
        if torch.equal(new, meds):
            break
        meds = new
    return meds.sort(dim=1).values


def segments(x, spec, clips: int) -> torch.Tensor:
    """x [clips*T, 1+P, D] -> the patch tokens of each segment, clip-major,
    [clips*S, dur*P, D]."""
    return x[:, 1:].reshape(clips * spec.frames_out, -1, x.shape[2])


def cluster(x, spec, clips: int, iter_limit: int,
            medoids: Optional[list] = None, replay: bool = False):
    """x [clips*T, 1+P, D] -> [clips*S, 1+K, D].  With `replay` the medoid
    ids are taken from the front of `medoids` (a recomputation of the same
    forward); else they are computed by the plan's algorithm, and appended
    to `medoids` if given."""
    S, dur, K = spec.frames_out, spec.dur, spec.k
    P, D = x.shape[1] - 1, x.shape[2]
    cls = x[:, 0].reshape(clips, S, dur, D).mean(dim=2)
    tok = segments(x, spec, clips)
    if replay:
        meds = medoids.pop(0)
    elif spec.algo == "spectral":
        meds = spectral.medoids(tok.detach(), spec, iter_limit, kmedoids)
    else:
        meds = kmedoids(tok.detach(), K, iter_limit)
    if not replay and medoids is not None:
        medoids.append(meds)
    picked = torch.gather(tok, 1, meds[..., None].expand(-1, -1, D))
    return torch.cat([cls.reshape(clips * S, 1, D), picked], dim=1)


# ------------------------------------------------------------------- towers
def stem(W: Dict[str, torch.Tensor], s, video: torch.Tensor,
         num: Numerics) -> torch.Tensor:
    """[n, T, 3, H, W] uint8 -> the tokens entering the first vision block,
    [n*T, 1+P, D]."""
    n, T = video.shape[:2]
    P, Wd = s.patch, s.width
    g = s.resolution // P
    mean = torch.tensor(CLIP_MEAN, device=video.device)[:, None, None]
    std = torch.tensor(CLIP_STD, device=video.device)[:, None, None]
    x = (video.reshape(n * T, 3, s.resolution, s.resolution).float()
         / 255.0 - mean) / std
    x = x.reshape(n * T, 3, g, P, g, P).permute(0, 2, 4, 1, 3, 5)
    x = num.mm(x.reshape(n * T, g * g, 3 * P * P),
               W["clip.visual.conv1.weight"].reshape(Wd, -1).t())
    cls = W["clip.visual.class_embedding"].expand(n * T, 1, Wd)
    x = torch.cat([cls, x], dim=1) + W["clip.visual.positional_embedding"]
    return layer_norm(x, W["clip.visual.ln_pre.weight"],
                      W["clip.visual.ln_pre.bias"])


def frame_features(W: Dict[str, torch.Tensor], s, video: torch.Tensor,
                   num: Numerics, medoids: Optional[list] = None,
                   replay: bool = False) -> torch.Tensor:
    """[n, T, 3, H, W] uint8 -> [n, T_final, E] fp32 CLS features.
    `medoids` collects the medoid ids of each cluster layer in order, or
    with `replay` hands them back (from a copy of the list)."""
    n = video.shape[0]
    x = stem(W, s, video, num)
    ids = list(medoids) if replay else medoids
    for i, spec in enumerate(s.plan):
        if spec is not None:
            x = cluster(x, spec, n, s.iter_limit, ids, replay)
        x = block(x, W, f"clip.visual.transformer.resblocks.{i}.", s.heads,
                  None, num)
    x = layer_norm(x[:, 0], W["clip.visual.ln_post.weight"],
                   W["clip.visual.ln_post.bias"])
    x = num.mm(x, W["clip.visual.proj"])
    return x.reshape(n, -1, x.shape[-1])


def text_features(W, s, ids: torch.Tensor, num: Numerics) -> torch.Tensor:
    """[B, L] token ids -> [B, E]."""
    L = ids.shape[1]
    x = W["clip.token_embedding.weight"][ids] \
        + W["clip.positional_embedding"][:L]
    mask = torch.full((L, L), float("-inf"), device=ids.device).triu(1)
    for i in range(s.text_layers):
        x = block(x, W, f"clip.transformer.resblocks.{i}.", s.text_heads,
                  mask, num)
    x = layer_norm(x, W["clip.ln_final.weight"], W["clip.ln_final.bias"])
    x = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
    return num.mm(x, W["clip.text_projection"])


def _unit(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)


def frame_mask(s, video_mask: torch.Tensor) -> torch.Tensor:
    """The mask of the last frame of each final segment."""
    T, Tf = s.frames, s.final_frames
    return video_mask[:, (T // Tf) - 1::T // Tf]


def video_vectors(frames: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """meanP: [n, Tf, E] frame features, [n, Tf] mask -> [n, E] unit."""
    m = mask.float()[..., None]
    cnt = m.sum(dim=1)
    pooled = (_unit(frames) * m).sum(dim=1) / torch.where(
        cnt == 0, torch.ones_like(cnt), cnt)
    return _unit(pooled)


def loss(text: torch.Tensor, video: torch.Tensor,
         logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over the batch's [B, E] text and unit video
    vectors."""
    sim = logit_scale.exp() * (_unit(text) @ video.t())
    ce = lambda m: -torch.diagonal(torch.log_softmax(m, dim=-1)).mean()
    return 0.5 * (ce(sim) + ce(sim.t()))
