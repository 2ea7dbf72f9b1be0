# coding=utf-8
"""Configuration tree of the PyTorch port.

An own copy of the JAX package's `config.py` (CLIP_ARCHS, ClusterConfig,
BlockClusterSpec, build_cluster_plan, ModelConfig, make_run_config, the
per-dataset `preset`s, `to_dict` and `save_hparams`), so the port imports
nothing of that package.  The fields are the same, so configs built from
the same keywords compare field by field.  `remat` recomputes each
transformer block in the backward (`torch.utils.checkpoint`).
`tensor_parallel`, `sequence_parallel`, `pipeline_parallel` and
`pipeline_microbatches` are run by the `Trainer` (`parallel/mesh.py`,
`parallel/pipeline.py`); tensor and pipeline parallelism together raise,
as in JAX.  `fused_attention` is accepted and ignored: the JAX package
turns it off under tensor and under pipeline parallelism, as
`make_run_config` does here so that the configs compare equal, but the
port's CUDA tensors always take kernels A and B, under tensor parallelism
on each rank's heads, under pipeline parallelism on each stage's
microbatches.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

# per-CLIP-variant optimizer defaults (reference: params.py:9-16)
CLIP_DEFAULT_PARAMS = {
    "RN50": {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8},
    "RN101": {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8},
    "RN50x4": {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8},
    "ViT-B/32": {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6},
    "ViT-B/16": {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6},
}

# architecture table of the supported CLIP variants (reference:
# modules/clip.py:554-577 infers these from a state dict's shapes)
CLIP_ARCHS = {
    "ViT-B/32": dict(embed_dim=512, image_resolution=224, vision_layers=12,
                     vision_width=768, vision_patch_size=32, context_length=77,
                     vocab_size=49408, transformer_width=512,
                     transformer_heads=8, transformer_layers=12),
    "ViT-B/16": dict(embed_dim=512, image_resolution=224, vision_layers=12,
                     vision_width=768, vision_patch_size=16, context_length=77,
                     vocab_size=49408, transformer_width=512,
                     transformer_heads=8, transformer_layers=12),
    # the ResNet towers (models/resnet.py)
    "RN50": dict(embed_dim=1024, image_resolution=224,
                 vision_layers=(3, 4, 6, 3), vision_width=64,
                 vision_patch_size=None, context_length=77, vocab_size=49408,
                 transformer_width=512, transformer_heads=8,
                 transformer_layers=12),
    "RN101": dict(embed_dim=512, image_resolution=224,
                  vision_layers=(3, 4, 23, 3), vision_width=64,
                  vision_patch_size=None, context_length=77, vocab_size=49408,
                  transformer_width=512, transformer_heads=8,
                  transformer_layers=12),
}


@dataclass(frozen=True)
class ClusterConfig:
    """Token-clustering configuration (reference: params.py:192-282)."""
    inter: bool = False                       # --cluster_inter
    algo: str = "kmediods++"                  # --cluster_algo
    cluster_num_blocks: Tuple[int, ...] = ()  # --cluster_num_blocks
    target_frames_blocks: Tuple[int, ...] = ()  # --target_frames_blocks
    distance: str = "euclidean"               # --cluster_distance
    threshold: float = 1e-5                   # --cluster_threshold
    iter_limit: int = 100                     # --cluster_iter_limit
    minkowski_p: float = 2.0                  # --minkowski_norm_p
    aggregation: Optional[str] = None         # --aggregation (None | 'mean')
    pre_norm: bool = False                    # --pre_norm
    id_sort: bool = True
    spectral_sigma: float = 2.0               # --spectral_sigma
    spectral_graph: str = "HeatKernel"        # --spectral_graph
    spectral_knn_k: int = 1                   # --spectral_knn_k
    spectral_spg: bool = False                # --spectral_spg
    svd_correct_sign: bool = True             # --svd_correct_sign
    spectral_solver: str = "eigh"
    cluster_embedding: bool = False           # --cluster_embedding
    cluster_embed_from_clip: bool = True      # --cluser_embed_from_clip
    cluster_frame_embedding: bool = False     # --cluster_frame_embedding
    adaptive_cls: bool = False                # --adaptive_cls
    deep_cluster: bool = False                # --deep_cluster
    cluster_inter_dim: int = 256              # --cluster_inter_dim

    def __post_init__(self):
        if self.algo not in ("kmediods++", "pooling", "sparse_sampling",
                             "spectral", "temporal_shift", "token_shift"):
            raise ValueError(f"unknown cluster algo {self.algo!r}")
        if self.distance not in ("euclidean", "cosine"):
            raise ValueError(f"unknown cluster distance {self.distance!r}")
        if self.spectral_graph not in ("HeatKernel", "KNN"):
            raise ValueError(f"unknown spectral graph {self.spectral_graph!r}")
        if self.deep_cluster and self.inter:
            raise ValueError("deep_cluster and cluster_inter are mutually "
                             "exclusive (params.py:287)")


@dataclass(frozen=True)
class BlockClusterSpec:
    """Static shape plan of the clustering module before one block
    (reference: modules/cluster/cluster.py:15-63)."""
    block_id: int                 # 1-based transformer block index
    algo: str
    before_cluster_num: int       # tokens per frame entering the block (w/o CLS)
    cluster_num: int              # medoid tokens per segment leaving the block
    before_frames: int
    after_frames: int
    frame_duration: int           # before_frames // after_frames
    spectral_knn_k: int = 0
    spg_s_kernel: int = 0
    spg_t_kernel: int = 0

    @property
    def tokens_in(self) -> int:
        return self.before_cluster_num * self.frame_duration

    @property
    def tokens_out(self) -> int:
        return self.cluster_num


def build_cluster_plan(cluster: ClusterConfig, max_frames: int,
                       num_layers: int) -> Tuple[Optional[BlockClusterSpec], ...]:
    """Which blocks get a cluster module, with which static shapes.

    Block *i* (1-based) clusters iff its cluster count is > 1 and either the
    frame count or the cluster count shrinks against block *i-1*
    (reference: modules/cluster/cluster.py:23-37).
    """
    if not cluster.inter:
        return tuple(None for _ in range(num_layers))
    if len(cluster.cluster_num_blocks) != num_layers \
            or len(cluster.target_frames_blocks) != num_layers:
        raise ValueError(f"cluster_num_blocks and target_frames_blocks must "
                         f"have {num_layers} entries")
    tfb = (max_frames,) + tuple(cluster.target_frames_blocks)
    plan = []
    for block_id in range(1, num_layers + 1):
        cluster_num = cluster.cluster_num_blocks[block_id - 1]
        before_cluster_num = cluster.cluster_num_blocks[max(block_id - 2, 0)]
        after_frames = tfb[block_id]
        before_frames = tfb[block_id - 1]
        is_cluster = (cluster_num is not None and cluster_num > 1) and (
            before_frames > after_frames or before_cluster_num > cluster_num)
        if not is_cluster:
            plan.append(None)
            continue
        frame_duration = before_frames // after_frames
        if cluster.spectral_knn_k < 5:
            knn_k = int(5 * frame_duration) if before_cluster_num < 100 \
                else int(5 * frame_duration + 5)
        else:
            knn_k = cluster.spectral_knn_k
        s_kernel = 9 if before_cluster_num < 100 else 19
        plan.append(BlockClusterSpec(
            block_id=block_id, algo=cluster.algo,
            before_cluster_num=before_cluster_num, cluster_num=cluster_num,
            before_frames=before_frames, after_frames=after_frames,
            frame_duration=frame_duration, spectral_knn_k=knn_k,
            spg_s_kernel=s_kernel if cluster.spectral_spg else 0,
            spg_t_kernel=7 if cluster.spectral_spg else 0))
    return tuple(plan)


@dataclass(frozen=True)
class ModelConfig:
    """CLIP4Clip model configuration (reference: modules/clip4clip.py:127-197)."""
    clip_name: str = "ViT-B/32"
    sim_header: str = "meanP"
    loose_type: bool = True
    linear_patch: str = "2d"
    max_words: int = 32
    max_frames: int = 12
    cross_num_hidden_layers: int = 4
    cross_model_name: str = "cross-base"
    temperature_new: float = 1.0
    pre_visual_pooling: bool = False
    cross_chunk_size: int = 0
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    # tower activations; LayerNorm, softmax, clustering and similarity are
    # fp32 whatever this says
    compute_dtype: str = "bfloat16"
    # recompute each transformer block in the backward instead of keeping
    # its activations (torch.utils.checkpoint)
    remat: bool = False
    # TPU-only switches, accepted so configs compare with the JAX package's
    fused_attention: bool = True
    sequence_parallel: bool = False
    pipeline_parallel: int = 1
    pipeline_microbatches: int = 0

    def __post_init__(self):
        if self.clip_name not in CLIP_ARCHS:
            raise ValueError(f"unknown CLIP variant {self.clip_name}")
        if self.sim_header not in ("meanP", "seqLSTM", "seqTransf",
                                   "tightTransf"):
            raise ValueError(f"unknown sim_header {self.sim_header!r}")
        if self.linear_patch not in ("2d", "3d"):
            raise ValueError(f"unknown linear_patch {self.linear_patch!r}")
        if self.sim_header == "tightTransf" and self.loose_type:
            raise ValueError("tightTransf needs loose_type=False")

    @property
    def arch(self) -> dict:
        return CLIP_ARCHS[self.clip_name]

    @property
    def final_frames(self) -> int:
        # reference: clip4clip.py:156
        if (self.cluster.inter or self.cluster.deep_cluster) \
                and self.cluster.target_frames_blocks:
            return self.cluster.target_frames_blocks[-1]
        return self.max_frames

    @property
    def f_frame_duration(self) -> int:
        return self.max_frames // self.final_frames

    def cluster_plan(self) -> Tuple[Optional[BlockClusterSpec], ...]:
        return build_cluster_plan(self.cluster, self.max_frames,
                                  self.arch["vision_layers"])


@dataclass(frozen=True)
class DataConfig:
    """Dataset / pipeline configuration (reference: params.py:35-87)."""
    datatype: str = "msrvtt"
    data_dir: str = ""
    train_csv: str = ""
    val_csv: str = ""
    data_path: str = ""
    features_path: str = ""
    lmdb_dataset: Optional[str] = None
    num_thread_reader: int = 1
    feature_framerate: int = 1
    max_words: int = 32
    max_frames: int = 12
    slice_framepos: int = 2
    train_frame_order: int = 0
    eval_frame_order: int = 0
    expand_msrvtt_sentences: bool = False
    image_resolution: int = 224
    video_suffix: str = ".mp4"
    raw_pixels: bool = True


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer / schedule configuration (reference: params.py:62-114)."""
    optim: str = "BertAdam"
    lr: float = 5e-4
    coef_lr: float = 1.0
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-6
    weight_decay: float = 0.2
    warmup_proportion: float = 0.1
    schedule: str = "warmup_cosine"
    lr_mode: str = "cos"
    clip_grad_norm: float = 1.0
    gradient_accumulation_steps: int = 1
    end_lr: float = 1e-8


@dataclass(frozen=True)
class RunConfig:
    """Top-level run configuration (reference: params.py:19-326)."""
    do_train: bool = True
    do_eval: bool = False
    inference_speed_test: bool = False
    output_dir: str = "output"
    resume: Optional[str] = None
    load_from_pretrained: bool = False
    init_model: Optional[str] = None
    pretrained_dir: str = os.path.expanduser("~/models/pretrained")
    epochs: int = 5
    batch_size: int = 128
    batch_size_val: int = 128
    seed: int = 42
    n_display: int = 100
    freeze_layer_num: int = 0
    freeze_clip: bool = False
    precision: str = "bf16"
    profile_dir: Optional[str] = None
    profile_steps: int = 5
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data_parallel: int = 0
    tensor_parallel: int = 1
    fsdp: bool = False

    @property
    def new_added_modules(self) -> Tuple[str, ...]:
        return ("time_embedding", "frame_embedding", "deepcluster")


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def save_hparams(directory: str, cfg: RunConfig) -> str:
    """JSON snapshot `<directory>/hparams_train.json` with the JAX package's
    keys and layout (reference: params.py:329-335)."""
    os.makedirs(directory, exist_ok=True)
    filename = os.path.join(directory, "hparams_train.json")
    with open(filename, "w") as f:
        json.dump(to_dict(cfg), f, indent=4, sort_keys=True, default=str)
    return filename


def make_run_config(**kw) -> RunConfig:
    """Build a RunConfig from flat flag-style keywords, with the reference's
    post-parse derivations (params.py:286-321)."""
    model_kw, data_kw, optim_kw, cluster_kw, run_kw = {}, {}, {}, {}, {}
    groups = (
        ({f.name for f in dataclasses.fields(ClusterConfig)}, cluster_kw),
        ({f.name for f in dataclasses.fields(ModelConfig)}, model_kw),
        ({f.name for f in dataclasses.fields(DataConfig)}, data_kw),
        ({f.name for f in dataclasses.fields(OptimConfig)}, optim_kw),
        ({f.name for f in dataclasses.fields(RunConfig)}, run_kw),
    )
    for k, v in kw.items():
        for names, dest in groups:
            if k in names:
                dest[k] = v
                break
        else:
            raise TypeError(f"unknown config field: {k}")
    for shared in ("max_words", "max_frames"):
        if shared in model_kw:
            data_kw.setdefault(shared, model_kw[shared])

    model_kw["cluster"] = ClusterConfig(**cluster_kw)
    if model_kw.get("sim_header") == "tightTransf":
        model_kw["loose_type"] = False
    if data_kw.get("datatype") == "activity":
        model_kw.setdefault("pre_visual_pooling", True)
    # the same field rewrites as the JAX package, so configs compare equal
    # (`fused_attention` off under tensor or pipeline parallelism is not
    # read: the port's CUDA tensors take kernels A and B on each rank's
    # heads, on each stage's microbatches)
    if run_kw.get("tensor_parallel", 1) > 1:
        model_kw["fused_attention"] = False
        if model_kw.get("pipeline_parallel", 1) > 1:
            raise ValueError("pipeline_parallel and tensor_parallel cannot "
                             "be combined on one mesh")
    elif model_kw.get("sequence_parallel"):
        raise ValueError("sequence_parallel requires tensor_parallel > 1")
    if model_kw.get("pipeline_parallel", 1) > 1:
        model_kw["fused_attention"] = False
    model = ModelConfig(**model_kw)

    for name, val in CLIP_DEFAULT_PARAMS.get(model.clip_name, {}).items():
        optim_kw.setdefault(name, val)
    return RunConfig(model=model, data=DataConfig(**data_kw),
                     optim=OptimConfig(**optim_kw), **run_kw)


def flagship_config(compute_dtype: str = "bfloat16") -> ModelConfig:
    """The repo's flagship retrieval configuration (bench.py:149-156,
    `_flagship_cfg`): ViT-B/32, meanP, 12 frames, 32 words, kmediods++ with
    49 tokens per block and 12 -> 6 frames before block 7."""
    return make_run_config(
        clip_name="ViT-B/32", sim_header="meanP", max_words=32, max_frames=12,
        compute_dtype=compute_dtype, inter=True, algo="kmediods++",
        cluster_num_blocks=(49,) * 12,
        target_frames_blocks=(12,) * 6 + (6,) * 6).model


# ---------------------------------------------------------------------------
# Canonical per-dataset presets (reference: scripts/*.sh case blocks)
# ---------------------------------------------------------------------------
def preset(name: str, **overrides) -> RunConfig:
    """Named experiment presets matching the reference's script configs:
    the JAX package's seven."""
    presets = {
        # scripts/msrvtt.sh:78-93 (eclip_msrvtt_62): ViT-B/32 kmediods++ 12->6
        "msrvtt_vitb32_k6": dict(
            datatype="msrvtt", clip_name="ViT-B/32", sim_header="meanP",
            max_words=32, max_frames=12, expand_msrvtt_sentences=True,
            inter=True, algo="kmediods++",
            cluster_num_blocks=(49,) * 12,
            target_frames_blocks=(12,) * 6 + (6,) * 6,
            optim="AdamW", lr=2e-3, coef_lr=1e-3, weight_decay=0.2, epochs=5),
        # scripts/msrvtt.sh:94-108 (eclip_msrvtt_63): 12->4
        "msrvtt_vitb32_k4": dict(
            datatype="msrvtt", clip_name="ViT-B/32", sim_header="meanP",
            max_words=32, max_frames=12, expand_msrvtt_sentences=True,
            inter=True, algo="kmediods++",
            cluster_num_blocks=(49,) * 12,
            target_frames_blocks=(12,) * 6 + (4,) * 6,
            optim="AdamW", lr=2e-3, coef_lr=1e-3, weight_decay=0.2, epochs=5),
        # scripts/lsmdc.sh:90-103 (lsmdc_04): ViT-B/32 kmediods++ 12->6
        "lsmdc_vitb32_k6": dict(
            datatype="lsmdc", clip_name="ViT-B/32", sim_header="meanP",
            max_words=32, max_frames=12,
            inter=True, algo="kmediods++",
            cluster_num_blocks=(49,) * 12,
            target_frames_blocks=(12,) * 6 + (6,) * 6,
            optim="AdamW", lr=2e-3, coef_lr=1e-3, weight_decay=0.2, epochs=5),
        # scripts/lsmdc.sh:127-140 (lsmdc_22): spectral-KNN 12->6
        "lsmdc_vitb32_spectral6": dict(
            datatype="lsmdc", clip_name="ViT-B/32", sim_header="meanP",
            max_words=32, max_frames=12,
            inter=True, algo="spectral", spectral_graph="KNN",
            cluster_num_blocks=(49,) * 12,
            target_frames_blocks=(12,) * 6 + (6,) * 6,
            optim="AdamW", lr=2e-3, coef_lr=1e-3, weight_decay=0.2, epochs=5),
        # scripts/msvd.sh:72-83 (msvd_22): kmediods++ 12->4
        "msvd_vitb32_k4": dict(
            datatype="msvd", clip_name="ViT-B/32", sim_header="meanP",
            max_words=32, max_frames=12,
            inter=True, algo="kmediods++",
            cluster_num_blocks=(49,) * 12,
            target_frames_blocks=(12,) * 6 + (4,) * 6,
            optim="AdamW", lr=2e-3, coef_lr=1e-3, weight_decay=0.2, epochs=5),
        # scripts/activitynet.sh:29-68: paragraph retrieval, 60 frames
        "activity_vitb32": dict(
            datatype="activity", clip_name="ViT-B/32", sim_header="meanP",
            max_words=77, max_frames=60,
            inter=True, algo="kmediods++",
            cluster_num_blocks=(49,) * 12,
            target_frames_blocks=(60,) * 6 + (15,) * 6,
            optim="AdamW", lr=2e-3, coef_lr=1e-3, weight_decay=0.2, epochs=8),
        # scripts/msrvtt.sh:46-51 (b16): ViT-B/16 kmediods++ 12->6 frames
        # before block 7, 2 x 196 patch tokens -> 160 medoids per segment
        "msrvtt_vitb16_k6": dict(
            datatype="msrvtt", clip_name="ViT-B/16", sim_header="meanP",
            max_words=32, max_frames=12, expand_msrvtt_sentences=True,
            inter=True, algo="kmediods++",
            cluster_num_blocks=(196,) * 6 + (160,) * 6,
            target_frames_blocks=(12,) * 6 + (6,) * 6,
            optim="AdamW", lr=2e-3, coef_lr=1e-3, weight_decay=0.2, epochs=5),
    }
    if name not in presets:
        raise KeyError(f"unknown preset {name}; available: {sorted(presets)}")
    cfg = dict(presets[name])
    cfg.update(overrides)
    return make_run_config(**cfg)
