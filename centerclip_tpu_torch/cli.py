# coding=utf-8
"""CLI flag surface (port of the JAX package's `cli.py`; reference:
params.py:19-326).

Every flag and default of the JAX package's parser, so the canonical
`scripts/*.sh` flags translate 1:1 (`python -m centerclip_tpu_torch.main
<flags>`); `args_to_run_config` funnels the namespace into the typed config
tree, equal field by field to the JAX package's.  Every header, tower
and patchify of the JAX package builds; `--sim_header seqLSTM` parses and
builds and raises at the similarity, as the JAX package's does.  Data
parallelism, FSDP, tensor and sequence parallelism and pipeline
parallelism run one process per GPU under `torchrun` (`--data_parallel`,
`--fsdp`, `--tensor_parallel`, `--sequence_parallel`,
`--pipeline_parallel`, `--pipeline_microbatches`); tensor and pipeline
parallelism together raise, as in JAX (`make_run_config`).
"""
from __future__ import annotations

import argparse
import os

from .config import RunConfig, make_run_config


def get_parser(description="CenterCLIP on Retrieval Task (PyTorch/CUDA)"
               ) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    # run mode
    p.add_argument("--do_train", type=int, default=1)
    p.add_argument("--do_eval", type=int, default=0)
    p.add_argument("--inference_speed_test", type=int, default=0)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of epoch 0's first "
                        "--profile_steps training steps into this directory")
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--debug", default=False, action="store_true")
    # datasets
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--lmdb_dataset", type=str, default=None)
    p.add_argument("--train_csv", type=str, default="")
    p.add_argument("--val_csv", type=str, default="")
    p.add_argument("--data_path", type=str, default="")
    p.add_argument("--features_path", type=str, default="")
    p.add_argument("--datatype", type=str, default="msrvtt",
                   choices=["msrvtt", "msvd", "lsmdc", "activity", "didemo"])
    p.add_argument("--video_suffix", type=str, default=".mp4",
                   help="video file suffix (.mp4 | .npy | .fstore entries)")
    p.add_argument("--raw_pixels", type=int, default=1,
                   help="1: ship uint8 frames and normalise on device (4x "
                        "less host->device traffic); 0: host float32 "
                        "normalisation like the reference")
    # training
    p.add_argument("--num_thread_reader", type=int, default=1)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--batch_size_val", type=int, default=3500)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--coef_lr", type=float, default=1.0)
    p.add_argument("--beta1", type=float, default=None)
    p.add_argument("--beta2", type=float, default=None)
    p.add_argument("--eps", type=float, default=None)
    p.add_argument("--wd", type=float, default=0.2)
    p.add_argument("--optim", type=str, default="BertAdam",
                   choices=["BertAdam", "AdamW"])
    p.add_argument("--warmup_proportion", type=float, default=0.1)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--clip_grad_norm", type=float, default=1.0)
    p.add_argument("--n_display", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max_words", type=int, default=20)
    p.add_argument("--max_frames", type=int, default=100)
    p.add_argument("--feature_framerate", type=int, default=1)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--resume", type=str, default=None)
    p.add_argument("--load_from_pretrained", type=int, default=0)
    p.add_argument("--init_model", type=str, default=None)
    p.add_argument("--expand_msrvtt_sentences", action="store_true")
    p.add_argument("--train_frame_order", type=int, default=0,
                   choices=[0, 1, 2])
    p.add_argument("--eval_frame_order", type=int, default=0,
                   choices=[0, 1, 2])
    p.add_argument("--freeze_layer_num", type=int, default=0)
    p.add_argument("--freeze_clip", type=int, default=0)
    p.add_argument("--slice_framepos", type=int, default=0, choices=[0, 1, 2])
    p.add_argument("--loose_type", action="store_true")
    p.add_argument("--linear_patch", type=str, default="2d",
                   choices=["2d", "3d"])
    p.add_argument("--sim_header", type=str, default="meanP",
                   choices=["meanP", "seqLSTM", "seqTransf", "tightTransf"])
    p.add_argument("--cross_num_hidden_layers", type=int, default=4)
    p.add_argument("--cross_model", type=str, default="cross-base",
                   help="cross-module archive: shipped name, local dir, "
                        ".tar.gz, or URL (params.py:97, base.py:34-70)")
    p.add_argument("--cross_chunk_size", type=int, default=0,
                   help="tightTransf: score this many text rows per cross-"
                        "model block (0 = all at once); bounds eval-gallery "
                        "memory like the reference's step_size split")
    p.add_argument("--pretrained_clip_name", type=str, default="ViT-B/32")
    p.add_argument("--pretrained_dir", type=str,
                   default=os.path.expanduser("~/models/pretrained"))
    p.add_argument("--precision", type=str, default="amp",
                   choices=["amp", "fp16", "fp32", "bf16"])
    p.add_argument("--fused_attention", type=int, default=1,
                   help="accepted for parity with the JAX package (which "
                        "turns it off under --tensor_parallel and "
                        "--pipeline_parallel); CUDA tensors always take "
                        "the port's attention kernels")
    p.add_argument("--remat", type=int, default=0,
                   help="rematerialize transformer blocks on backward "
                        "(activation-memory relief for long-video configs)")
    # parallelism (replaces --world_size/--local_rank/--init_method/--dp/...):
    # the JAX package's flags and defaults
    p.add_argument("--data_parallel", type=int, default=0,
                   help="devices, one torchrun process each, as the JAX "
                        "package counts them; the data shards are this "
                        "over --tensor_parallel or --pipeline_parallel; "
                        "0 = every process")
    p.add_argument("--tensor_parallel", type=int, default=1,
                   help="model-axis extent: Megatron column/row-parallel "
                        "blocks over this many ranks, which must divide "
                        "the processes and every block stack's heads")
    p.add_argument("--fsdp", type=int, default=0,
                   help="shard parameters, gradients and Adam moments over "
                        "the data axis (FSDP)")
    p.add_argument("--sequence_parallel", type=int, default=0,
                   help="split the towers' residual stream's tokens over "
                        "the model axis between the parallel layers "
                        "(needs --tensor_parallel > 1)")
    p.add_argument("--pipeline_parallel", type=int, default=1,
                   help="pipe-axis extent: GPipe stages over this many "
                        "ranks, which must divide the processes (not with "
                        "--tensor_parallel)")
    p.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="GPipe microbatch count; 0 = the largest <= 4 x "
                        "stages that divides a rank's rows")
    # cluster algorithms
    p.add_argument("--cluster_algo", type=str, default="kmediods++",
                   choices=["kmediods++", "pooling", "sparse_sampling",
                            "spectral", "temporal_shift", "token_shift"])
    p.add_argument("--cluster_embedding", type=int, default=0)
    p.add_argument("--cluser_embed_from_clip", type=int, default=1)
    p.add_argument("--cluster_frame_embedding", type=int, default=0)
    p.add_argument("--adaptive_cls", type=int, default=0)
    p.add_argument("--aggregation", type=str, default=None,
                   choices=["mean", "None"])
    p.add_argument("--cluster_iter_limit", type=int, default=100)
    p.add_argument("--cluster_distance", type=str, default="euclidean",
                   choices=["euclidean", "cosine"])
    p.add_argument("--cluster_threshold", type=float, default=1e-5)
    p.add_argument("--minkowski_norm_p", type=float, default=2.0)
    p.add_argument("--cluster_inter", type=int, default=0)
    p.add_argument("--cluster_num_blocks", type=int, default=[0], nargs="+")
    p.add_argument("--target_frames_blocks", type=int, default=[12] * 12,
                   nargs="+")
    p.add_argument("--spectral_sigma", type=float, default=2.0)
    p.add_argument("--spectral_graph", type=str, default="HeatKernel",
                   choices=["HeatKernel", "KNN"])
    p.add_argument("--spectral_knn_k", type=int, default=1)
    p.add_argument("--spectral_spg", type=int, default=0)
    p.add_argument("--svd_correct_sign", type=int, default=1)
    p.add_argument("--spectral_solver", type=str, default="eigh",
                   choices=["eigh", "subspace"])
    p.add_argument("--deep_cluster", type=int, default=0)
    p.add_argument("--cluster_inter_dim", type=int, default=256)
    p.add_argument("--temperature_new", type=float, default=1.0)
    p.add_argument("--pre_norm", type=int, default=0)
    return p


def args_to_run_config(args: argparse.Namespace) -> RunConfig:
    """Funnel the argparse namespace into the typed config (the analogue of
    params.py:286-321 derivations, handled in make_run_config)."""
    precision = {"amp": "bf16", "fp16": "bf16", "bf16": "bf16",
                 "fp32": "fp32"}[args.precision]
    kw = dict(
        do_train=bool(args.do_train), do_eval=bool(args.do_eval),
        inference_speed_test=bool(args.inference_speed_test),
        output_dir=args.output_dir, resume=args.resume,
        load_from_pretrained=bool(args.load_from_pretrained),
        init_model=args.init_model, pretrained_dir=args.pretrained_dir,
        epochs=args.epochs, batch_size=args.batch_size,
        batch_size_val=args.batch_size_val, seed=args.seed,
        n_display=args.n_display, freeze_layer_num=args.freeze_layer_num,
        freeze_clip=bool(args.freeze_clip), precision=precision,
        profile_dir=args.profile_dir, profile_steps=args.profile_steps,
        data_parallel=args.data_parallel,
        tensor_parallel=args.tensor_parallel,
        fsdp=bool(args.fsdp),
        sequence_parallel=bool(args.sequence_parallel),
        pipeline_parallel=args.pipeline_parallel,
        pipeline_microbatches=args.pipeline_microbatches,
        # model
        clip_name=args.pretrained_clip_name, sim_header=args.sim_header,
        loose_type=args.loose_type, linear_patch=args.linear_patch,
        max_words=args.max_words, max_frames=args.max_frames,
        cross_num_hidden_layers=args.cross_num_hidden_layers,
        cross_model_name=args.cross_model,
        cross_chunk_size=args.cross_chunk_size,
        temperature_new=args.temperature_new,
        remat=bool(args.remat),
        fused_attention=bool(args.fused_attention),
        compute_dtype="bfloat16" if precision == "bf16" else "float32",
        # data
        datatype=args.datatype, data_dir=args.data_dir,
        train_csv=args.train_csv, val_csv=args.val_csv,
        data_path=args.data_path, features_path=args.features_path,
        lmdb_dataset=args.lmdb_dataset,
        num_thread_reader=args.num_thread_reader,
        feature_framerate=args.feature_framerate,
        slice_framepos=args.slice_framepos,
        train_frame_order=args.train_frame_order,
        eval_frame_order=args.eval_frame_order,
        expand_msrvtt_sentences=args.expand_msrvtt_sentences,
        video_suffix=args.video_suffix,
        raw_pixels=bool(args.raw_pixels),
        # optim
        optim=args.optim, coef_lr=args.coef_lr, weight_decay=args.wd,
        warmup_proportion=args.warmup_proportion,
        clip_grad_norm=args.clip_grad_norm,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        # cluster: the block plans reach DeepCluster too (the JAX package's
        # CLI drops them without --cluster_inter, so its deep_cluster_plan
        # fails on any --deep_cluster run)
        inter=bool(args.cluster_inter), algo=args.cluster_algo,
        cluster_num_blocks=tuple(args.cluster_num_blocks)
        if args.cluster_inter or args.deep_cluster else (),
        target_frames_blocks=tuple(args.target_frames_blocks)
        if args.cluster_inter or args.deep_cluster else (),
        distance=args.cluster_distance, threshold=args.cluster_threshold,
        iter_limit=args.cluster_iter_limit,
        minkowski_p=args.minkowski_norm_p,
        aggregation=None if args.aggregation in (None, "None")
        else args.aggregation,
        pre_norm=bool(args.pre_norm),
        spectral_sigma=args.spectral_sigma,
        spectral_graph=args.spectral_graph,
        spectral_knn_k=args.spectral_knn_k,
        spectral_spg=bool(args.spectral_spg),
        svd_correct_sign=bool(args.svd_correct_sign),
        spectral_solver=args.spectral_solver,
        cluster_embedding=bool(args.cluster_embedding),
        cluster_embed_from_clip=bool(args.cluser_embed_from_clip),
        cluster_frame_embedding=bool(args.cluster_frame_embedding),
        adaptive_cls=bool(args.adaptive_cls),
        deep_cluster=bool(args.deep_cluster),
        cluster_inter_dim=args.cluster_inter_dim,
    )
    # optimizer defaults per CLIP variant are applied in make_run_config;
    # drop None lr/betas so the defaults kick in
    for name in ("lr", "beta1", "beta2", "eps"):
        v = getattr(args, name)
        if v is not None:
            kw[name] = v
    cfg = make_run_config(**kw)
    return cfg


def parse_args(argv=None) -> RunConfig:
    args = get_parser().parse_args(argv)
    cfg = args_to_run_config(args)
    return cfg
