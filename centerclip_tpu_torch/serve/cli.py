# coding=utf-8
"""Deployment CLI (port of the JAX package's `serve/cli.py`): build a
gallery index from a dataset and a checkpoint, then answer text queries
against it, once or as an HTTP daemon, on the GPU.

  # encode the evaluation gallery and save a quantised index
  python -m centerclip_tpu_torch.serve.cli build \\
      --output_dir /tmp/serve --datatype msrvtt --features_path ... \\
      --init_model ckpt.pth.tar --index_path gallery.npz --quantize int8

  # answer queries from the saved index (JSON lines on stdout)
  python -m centerclip_tpu_torch.serve.cli query \\
      --output_dir /tmp/serve --init_model ckpt.pth.tar \\
      --index_path gallery.npz --query "a man cooking" --topk 5

  # JSON-over-HTTP service (serve/http.py)
  python -m centerclip_tpu_torch.serve.cli serve \\
      --output_dir /tmp/serve --init_model ckpt.pth.tar \\
      --index_path gallery.npz --port 8080

Every flag of `centerclip_tpu_torch.cli` is accepted (model variant,
cluster configuration, dataset paths; the parallel strategies are refused
there: one process, one GPU); the serve flags are below.  Weights load as
`main` loads them: --init_model, else the pretrained CLIP archive when it
is there, else the seeded initialisation.  `main(argv, device)` runs on the
card unless the caller names another device; with none given and no CUDA
device it raises.  Indexes are the JAX package's `.npz` files, so either
package reads what the other wrote.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Dict, Iterator, List, Optional, Sequence

import torch

logger = logging.getLogger(__name__)


def _serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="centerclip_tpu_torch.serve.cli", add_help=False,
        description="build / query a video retrieval index")
    p.add_argument("command", choices=["build", "query", "serve"])
    p.add_argument("--index_path", type=str, required=True,
                   help="gallery .npz (written by build, read by query)")
    p.add_argument("--index_type", type=str, default="flat",
                   choices=["flat", "ivf"],
                   help="flat = exact; ivf = cluster-pruned low-latency "
                        "(serve/ivf.py; build)")
    p.add_argument("--n_clusters", type=int, default=0,
                   help="IVF cells; 0 = ~sqrt(N) (build --index_type ivf)")
    p.add_argument("--nprobe", type=int, default=8,
                   help="IVF cells probed per query (build --index_type ivf)")
    p.add_argument("--quantize", type=str, default="float32",
                   choices=("float32", "bfloat16", "int8"),
                   help="gallery storage dtype (build)")
    p.add_argument("--query", action="append", default=[],
                   help="query text (repeatable)")
    p.add_argument("--queries_file", type=str, default="",
                   help="file with one query per line (query)")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--host", type=str, default="127.0.0.1",
                   help="bind address (serve)")
    p.add_argument("--port", type=int, default=8080,
                   help="bind port; 0 = pick a free port (serve)")
    return p


# --------------------------------------------------------------------- model
def load_model_and_params(cfg, device):
    """The model on `device`, its weights loaded as `main` loads them:
    --init_model, else `<pretrained_dir>/ViT-B-*.pt` when it is there,
    else the seeded initialisation.  (The module holds its parameters, so
    this returns the model alone.)"""
    from ..main import PRETRAINED_FILES
    from ..models.clip4clip import CLIP4Clip
    from ..train import state as state_mod

    model = CLIP4Clip(cfg.model, device=device, seed=cfg.seed)
    pt_name = PRETRAINED_FILES.get(cfg.model.clip_name)
    pretrained = os.path.join(cfg.pretrained_dir, pt_name or "")
    if cfg.init_model:
        _, report = state_mod.import_torch_checkpoint(
            cfg.init_model, cfg.model, model=model)
        logger.info("init_model loaded; missing=%d unexpected=%d",
                    len(report["missing"]), len(report["unexpected"]))
    elif pt_name and os.path.exists(pretrained):
        state_mod.init_from_pretrained_clip(
            pretrained, cfg.model, model=model,
            temperature_new=cfg.model.temperature_new)
        logger.info("pretrained CLIP loaded from %s", pretrained)
    else:
        logger.warning("no checkpoint given and no pretrained CLIP at %s — "
                       "serving RANDOM weights", pretrained)
    return model


# ------------------------------------------------------------------- gallery
def gallery_video_ids(dataset, multi_sentence: bool,
                      cut_off_points: Sequence[int]) -> List[str]:
    """One id per gallery row, matching the rows the Evaluator encodes.
    Multi-sentence datasets repeat each video once per caption; the gallery
    keeps the unique videos at the caption cut-offs."""
    if hasattr(dataset, "sentences_dict"):
        row_ids = [str(dataset.sentences_dict[i][0])
                   for i in range(len(dataset))]
    elif hasattr(dataset, "data") and "video_id" in getattr(
            dataset.data, "columns", ()):
        row_ids = [str(v) for v in dataset.data["video_id"].values]
    elif hasattr(dataset, "pairs"):
        # FrameStoreClipDataset list[(video_id, caption)], DiDeMo
        # dict{i: (video_id, sub_id)}, ActivityNet
        # dict{i: (pseudo_id, video_id, sub_id)}
        pairs = dataset.pairs
        if isinstance(pairs, dict):
            pairs = [pairs[i] for i in range(len(pairs))]
        row_ids = [str(p[1] if len(p) == 3 else p[0]) for p in pairs]
    else:
        logger.warning(
            "dataset %s exposes no video ids (no sentences_dict / data "
            "frame / pairs) — falling back to synthetic video{i} ids; "
            "query results will NOT name real videos",
            type(dataset).__name__)
        row_ids = [f"video{i}" for i in range(len(dataset))]
    if multi_sentence:
        return [row_ids[c - 1] for c in cut_off_points]
    return row_ids


def _concat_rows(parts: List[torch.Tensor]) -> torch.Tensor:
    """Row blocks -> one tensor, pinned when every block is (`torch.cat`
    alone hands back pageable memory)."""
    if len(parts) == 1:
        return parts[0]
    shape = (sum(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:])
    out = torch.empty(shape, dtype=parts[0].dtype,
                      pin_memory=all(p.is_pinned() for p in parts))
    return torch.cat(parts, out=out)


def _take_rows(x: torch.Tensor, rows: List[int]) -> torch.Tensor:
    """x[rows], pinned when x is (advanced indexing alone is not)."""
    out = torch.empty((len(rows),) + tuple(x.shape[1:]), dtype=x.dtype,
                      pin_memory=x.is_pinned())
    return torch.index_select(x, 0, torch.as_tensor(rows, dtype=torch.long),
                              out=out)


def gallery_batches(batches, multi_sentence: bool,
                    cut_off_points: Sequence[int], batch_size: int
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield {"video", "video_mask"} gallery batches of `batch_size` rows
    as tensors (numpy input is wrapped without a copy; pinned input stays
    pinned).  Multi-sentence rows are filtered to the unique videos (the
    Evaluator's cut-off rule) and re-batched so every encode is
    full-width."""
    cut0 = [c - 1 for c in (cut_off_points or [])]
    pend_v, pend_m, seen = [], [], 0

    def drain(force: bool):
        nonlocal pend_v, pend_m
        while pend_v and (sum(m.shape[0] for m in pend_m) >= batch_size
                          or force):
            video, vmask = _concat_rows(pend_v), _concat_rows(pend_m)
            take = min(batch_size, vmask.shape[0])
            yield {"video": video[:take], "video_mask": vmask[:take]}
            pend_v = [video[take:]] if take < vmask.shape[0] else []
            pend_m = [vmask[take:]] if take < vmask.shape[0] else []

    for batch in batches:
        video = torch.as_tensor(batch["video"])
        vmask = torch.as_tensor(batch["video_mask"])
        if multi_sentence:
            s_, e_ = seen, seen + vmask.shape[0]
            filt = [i - s_ for i in cut0 if s_ <= i < e_]
            seen = e_
            if not filt:
                continue
            video, vmask = _take_rows(video, filt), _take_rows(vmask, filt)
        pend_v.append(video)
        pend_m.append(vmask)
        yield from drain(force=False)
    yield from drain(force=True)


# ---------------------------------------------------------------------- main
def main(argv: Optional[Sequence[str]] = None, device=None):
    serve_args, rest = _serve_parser().parse_known_args(argv)

    from .. import resolve_device
    from ..cli import parse_args
    cfg = parse_args(rest)
    device = resolve_device(device)

    from ..models.tokenizer import SimpleTokenizer
    from .engine import RetrievalEngine
    from .index import load_index

    os.makedirs(cfg.output_dir, exist_ok=True)
    logging.basicConfig(level=logging.INFO)

    model = load_model_and_params(cfg, device)
    tokenizer = SimpleTokenizer()
    engine = RetrievalEngine(model, tokenizer=tokenizer, device=device)

    if serve_args.command == "build":
        from ..data.registry import DATALOADER_DICT
        slots = DATALOADER_DICT[cfg.data.datatype]
        test_fn = slots["test"] if slots["test"] is not None else slots["val"]
        loader, n = test_fn(cfg, tokenizer, device=device)
        ds = loader.dataset
        multi = bool(getattr(ds, "multi_sentence_per_video", False))
        cuts = list(getattr(ds, "cut_off_points", []))
        ids = gallery_video_ids(ds, multi, cuts)
        logger.info("building gallery: %d rows -> %d videos", n, len(ids))
        ivf_kw = {}
        if serve_args.index_type == "ivf":
            ivf_kw["nprobe"] = serve_args.nprobe
            if serve_args.n_clusters:
                ivf_kw["n_clusters"] = serve_args.n_clusters
        index = engine.build_index(
            gallery_batches(loader, multi, cuts, cfg.batch_size_val),
            ids, quantize=serve_args.quantize,
            index_type=serve_args.index_type, **ivf_kw)
        index.save(serve_args.index_path)
        print(json.dumps({"index_path": serve_args.index_path,
                          "videos": len(index), "dim": index.dim,
                          "index_type": serve_args.index_type,
                          "quantize": serve_args.quantize}))
        return index

    # ---- query / serve
    engine.index = load_index(serve_args.index_path, device=device)

    if serve_args.command == "serve":
        from .http import RetrievalServer
        server = RetrievalServer(engine, host=serve_args.host,
                                 port=serve_args.port,
                                 default_k=serve_args.topk)
        server.warmup()
        print(json.dumps({"listening": "http://%s:%d" % server.address,
                          "videos": len(engine.index)}), flush=True)
        server.serve_forever()
        return server

    queries = list(serve_args.query)
    if serve_args.queries_file:
        with open(serve_args.queries_file) as fp:
            queries += [ln.strip() for ln in fp if ln.strip()]
    if not queries:
        raise SystemExit("no queries: pass --query and/or --queries_file")
    results = engine.search(queries, k=serve_args.topk)
    for text, ranked in zip(queries, results):
        print(json.dumps({"query": text, "results": ranked}))
    return results


if __name__ == "__main__":
    main()
