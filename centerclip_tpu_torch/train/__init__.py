# coding=utf-8
"""Training and evaluation: optimizers and schedules, the train step and
epoch loop, checkpoints, and the two-phase retrieval evaluation."""
from .evaluate import Evaluator
from .loop import Trainer, make_train_step
from .metrics import (AverageMeter, compute_metrics,
                      reshape_multi_sentence_sim,
                      tensor_text_to_video_metrics, tensor_video_to_text_sim)
from .optim import build_optimizer, current_lr
from .state import (TrainState, export_torch_checkpoint, host_state,
                    import_torch_checkpoint, init_from_pretrained_clip,
                    load_checkpoint, resume, save_checkpoint)

__all__ = ["AverageMeter", "Evaluator", "Trainer", "TrainState",
           "build_optimizer", "compute_metrics", "current_lr",
           "export_torch_checkpoint", "host_state", "import_torch_checkpoint",
           "init_from_pretrained_clip", "load_checkpoint", "make_train_step",
           "reshape_multi_sentence_sim", "resume", "save_checkpoint",
           "tensor_text_to_video_metrics", "tensor_video_to_text_sim"]
