"""A tiny cell for the CPU tests: the recipe's structure (k-medoids
before a middle block, meanP, AdamW, the .fstore loader) at widths the
CPU runs in seconds, under an arch name registered with the program."""
from __future__ import annotations

ARCH = dict(embed_dim=32, image_resolution=32, vision_layers=4,
            vision_width=64, vision_heads=2, vision_patch_size=8,
            context_length=77, vocab_size=49408, transformer_width=32,
            transformer_heads=2, transformer_layers=2)
NAME = "tiny-bench"


def register() -> None:
    from centerclip_tpu_torch.config import CLIP_ARCHS, CLIP_DEFAULT_PARAMS
    CLIP_ARCHS[NAME] = {k: v for k, v in ARCH.items()}
    CLIP_DEFAULT_PARAMS[NAME] = CLIP_DEFAULT_PARAMS["ViT-B/32"]


def config(remat: bool = False, algo: str = "kmediods++",
           stream_scale: float = None) -> dict:
    """The tiny configuration; `algo` "spectral" clusters by spectral KNN
    (k = 10, sigma 2), and `stream_scale` is the weights' (`weights.py`)."""
    flags = ["--datatype", "msrvtt", "--max_words", "16", "--max_frames", "4",
             "--batch_size", "8", "--batch_size_val", "8", "--epochs", "5",
             "--optim", "AdamW", "--lr", "2e-3", "--coef_lr", "1e-3",
             "--wd", "0.2", "--warmup_proportion", "0.1", "--loose_type",
             "--sim_header", "meanP", "--expand_msrvtt_sentences",
             "--num_thread_reader", "2", "--cluster_inter", "1",
             "--cluster_algo", algo, "--pretrained_clip_name", NAME,
             "--cluster_num_blocks", "16", "16", "12", "12",
             "--target_frames_blocks", "4", "4", "2", "2"]
    if remat:
        flags += ["--remat", "1"]
    if algo == "spectral":
        flags += ["--spectral_graph", "KNN"]
    extra = {} if stream_scale is None else {"stream_scale": stream_scale}
    return {"name": "tiny", "flags": flags, "arch": dict(ARCH), **extra,
            "optim": dict(lr=2e-3, coef_lr=1e-3, weight_decay=0.2,
                          beta1=0.9, beta2=0.98, eps=1e-6,
                          warmup_proportion=0.1, clip_grad_norm=1.0,
                          end_lr=1e-8),
            "freeze_layer_num": 0}


TRAIN = {"kind": "train", "dataset": "tiny_16x4", "videos": 16,
         "captions_per_clip": 4, "warmup_steps": 1, "trace_steps": 2,
         "reference_chunk": 4}
ENCODE = {"kind": "encode", "clips": 16, "warmup_batches": 1,
          "reference_chunk": 4}
TRAIN_DDP = dict(TRAIN, kind="train_ddp", ranks=4,
                 flags=["--data_parallel", "4"])
# the manifest's traffic whose cell a tiny traffic kind stands in for
TRAFFIC = {"train": ("train", TRAIN), "encode": ("encode", ENCODE),
           "train_ddp": ("train_ddp4", TRAIN_DDP)}


def cell(kind: str, limits: dict = None, **config_kw):
    """A Cell of the manifest's first cell of `kind`, with the tiny
    configuration (`config`'s keywords) and traffic."""
    import json
    import os
    from portbench.harness import ROOT, Cell
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    traffic, tiny = TRAFFIC[kind]
    name = next(w["name"] for w in m["workloads"]
                if w["traffic"] == traffic)
    return Cell(name, manifest=m, config=config(**config_kw),
                traffic=dict(tiny),
                limits=limits if limits is not None else {})


def pin_medoids(setattr=setattr) -> None:
    """The first K tokens of every segment as its medoids, in the program
    and in the reference (k-medoids on the tokens, or on the spectral
    embedding): a flip of a near tie between two medoids, which the bf16
    and fp32 streams can make, cannot then hide the rest."""
    import torch
    import centerclip_tpu_torch.ops.cluster_layer as cluster_layer
    import centerclip_tpu_torch.ops.spectral as spectral
    import portbench.reference.model as ref

    def port(X, K, **kw):
        B, N = X.shape[:2]
        ids = torch.arange(K, dtype=torch.int32, device=X.device)
        return (torch.zeros((B, N), dtype=torch.int32, device=X.device),
                ids.expand(B, K).contiguous())

    setattr(cluster_layer, "kmedoids", port)
    setattr(spectral, "kmedoids", port)
    setattr(ref, "kmedoids", lambda X, K, iter_limit=100:
            torch.arange(K, device=X.device).expand(X.shape[0], K))
