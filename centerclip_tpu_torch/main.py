# coding=utf-8
"""Entry point: train / evaluate CLIP4Clip with the PyTorch/CUDA port
(port of the JAX package's `main.py`; reference: main.py:31-288).

    python -m centerclip_tpu_torch.main --do_train 1 --do_eval 1 \\
        --datatype msrvtt --train_csv ... --val_csv ... --data_path ... \\
        --features_path <videos dir, or a .fstore> --output_dir ... <flags>

The same flags as `python main.py` (see `cli.py`): fail-fast data-path
checks, `hparams_train.json`, the loaders (val falls back to test and
back), the model initialised from `--init_model`, or from
`<pretrained_dir>/ViT-B-32.pt` when it is there, or from scratch; then
either one evaluation (`--do_train 0 --do_eval 1`) or the epoch loop with an
evaluation after every epoch (ties update the best), `ckpt_<epoch>`,
`ckpt_best` and `ckpt.pth.tar`, and `--resume`.  `main(argv, device)` runs
on the card unless the caller names another device; with none given and no
CUDA device it raises.

On N GPUs, one process each (JAX `main.py` on an N-chip mesh):

    torchrun --nproc_per_node N -m centerclip_tpu_torch.main <flags> \
        [--fsdp 1] [--tensor_parallel T [--sequence_parallel 1] |
        --pipeline_parallel S [--pipeline_microbatches M]]

Each rank joins the process group before any device work, trains on its
model group's shard of every global batch of `--batch_size` (DDP, or FSDP
with `--fsdp 1`, over the N / T data shards; with `--tensor_parallel T`
the T ranks of a model group hold the slices of one model and read the
same rows; with `--pipeline_parallel S` the S ranks of a pipe group hold
one whole model each, read the same rows and run the towers' block runs
as S GPipe stages), and prints its epoch's mean loss to stdout.  The
evaluation's encode is spread over the ranks (each loads and encodes
every N-th batch on whole parameters: under FSDP or tensor parallelism
every rank first gathers them, `host_state`, into a whole copy), and
rank 0 alone scores it, logs and writes the checkpoints, while the other
ranks wait at a barrier.
"""
from __future__ import annotations

import logging
import os
import time

PRETRAINED_FILES = {"ViT-B/32": "ViT-B-32.pt", "ViT-B/16": "ViT-B-16.pt"}


def check_data_paths(cfg) -> None:
    """Fail fast on bad data paths: model init and the first loaders cost
    time that a missing features_path should not."""
    d = cfg.data
    for label, path, needed in (
            ("features_path", d.features_path, True),
            ("train_csv", d.train_csv, cfg.do_train
             and d.datatype == "msrvtt"),
            ("val_csv", d.val_csv, d.datatype == "msrvtt"),
            ("data_path", d.data_path, d.datatype != "msrvtt"
             or cfg.do_train)):
        if needed and path and not os.path.exists(path):
            raise SystemExit(f"--{label} does not exist: {path}")


def main(argv=None, device=None):
    import torch.distributed as dist
    from .cli import parse_args
    from .parallel.mesh import init_distributed
    cfg = parse_args(argv)
    # join the process group before any device work
    device = init_distributed(device)
    try:
        return _run(cfg, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(cfg, device):
    from .config import save_hparams
    from .data.registry import DATALOADER_DICT
    from .models.clip4clip import CLIP4Clip
    from .models.tokenizer import SimpleTokenizer
    from .parallel.mesh import (is_sharded, process_barrier, process_index,
                                world_size)
    from .train import state as state_mod
    from .train.evaluate import Evaluator
    from .train.loop import Trainer
    from .utils.logging import MetricWriter, setup_logging

    rank, world = process_index(), world_size()
    os.makedirs(cfg.output_dir, exist_ok=True)
    setup_logging(os.path.join(cfg.output_dir, "log.txt"),
                  level=logging.INFO, process_index=rank)
    logger = logging.getLogger("main")
    if rank == 0:
        save_hparams(cfg.output_dir, cfg)
    logger.info("device: %s, processes: %d", device, world)
    check_data_paths(cfg)

    tokenizer = SimpleTokenizer()
    model = CLIP4Clip(cfg.model, device=device, seed=cfg.seed)

    # ---- dataloaders (main.py:134-153: val falls back to test and
    # vice-versa per registry slots)
    if cfg.data.datatype not in DATALOADER_DICT:
        raise SystemExit(f"unknown --datatype {cfg.data.datatype}")
    slots = DATALOADER_DICT[cfg.data.datatype]
    test_fn = slots["test"] if slots["test"] is not None else slots["val"]
    test_loader, test_len = test_fn(cfg, tokenizer, device=device)
    logger.info("eval samples: %d", test_len)

    # ---- weights: --init_model, else the OpenAI archive when present
    # (clip4clip.py:28-124), else the seeded initialisation
    pt_name = PRETRAINED_FILES.get(cfg.model.clip_name)
    pretrained = os.path.join(cfg.pretrained_dir, pt_name or "")
    if cfg.init_model:
        _, report = state_mod.import_torch_checkpoint(
            cfg.init_model, cfg.model, model=model)
        logger.info("init_model loaded; missing=%d unexpected=%d",
                    len(report["missing"]), len(report["unexpected"]))
    elif pt_name and os.path.exists(pretrained):
        _, report = state_mod.init_from_pretrained_clip(
            pretrained, cfg.model, model=model,
            temperature_new=cfg.model.temperature_new)
        logger.info("pretrained CLIP loaded from %s; missing=%d",
                    pretrained, len(report["missing"]))
    else:
        logger.warning("no pretrained CLIP found at %s - training from "
                       "scratch", pretrained)

    multi_sentence = bool(getattr(test_loader.dataset,
                                  "multi_sentence_per_video", False))
    cut_offs = list(getattr(test_loader.dataset, "cut_off_points", []))

    # ---- eval-only path: every rank encodes its share of the batches,
    # rank 0 scores them (main.py:232-239 evaluates on rank 0 alone)
    if cfg.do_eval and not cfg.do_train:
        res = Evaluator(model).evaluate(
            test_loader, multi_sentence=multi_sentence,
            cut_off_points=cut_offs,
            inference_speed_test=cfg.inference_speed_test)
        if rank == 0:
            logger.info("eval R@1: %.2f", res["R1"])
        process_barrier("eval_only_done")
        return res

    # ---- training path (main.py:244-288)
    train_loader, n_train, sampler = slots["train"](cfg, tokenizer,
                                                    device=device)
    # ceil: the epoch-tail partial accumulator still steps (train/loop.py)
    accum = cfg.optim.gradient_accumulation_steps
    steps_per_epoch = (len(train_loader) + accum - 1) // accum
    total_steps = steps_per_epoch * cfg.epochs
    logger.info("train samples: %d, steps/epoch: %d, total steps: %d",
                n_train, steps_per_epoch, total_steps)

    trainer = Trainer(cfg, model, total_steps=total_steps)
    sharded = is_sharded(model)
    if rank == 0:
        trainer.metric_writer = MetricWriter(
            os.path.join(cfg.output_dir, "tensorboard"))
    # under FSDP or tensor parallelism every rank encodes its share of the
    # evaluation, and rank 0 exports, on a copy with whole parameters,
    # loaded from the gathered ones every epoch
    eval_model = (CLIP4Clip(cfg.model, device=device, seed=cfg.seed)
                  if sharded else model)
    evaluator = Evaluator(eval_model)

    start_epoch, best_r1, best_epoch = 0, 0.0, -1
    if cfg.resume:
        _, start_epoch, best_r1 = state_mod.resume(
            cfg.resume, trainer.state,
            load_weights_only=cfg.load_from_pretrained)
        logger.info("resumed from %s, starting at epoch %d (best R@1 %.2f)",
                    cfg.resume, start_epoch, best_r1)

    try:
        for epoch in range(start_epoch, cfg.epochs):
            sampler.set_epoch(epoch)
            t0 = time.time()
            loss, gstep = trainer.train_epoch(epoch, train_loader,
                                              n_display=cfg.n_display)
            logger.info("Epoch %d/%d done in %.1fs, mean loss %.4f",
                        epoch + 1, cfg.epochs, time.time() - t0, loss)
            if world > 1:
                # the log is rank 0's: every rank's own loss to stdout
                print(f"rank {rank} epoch {epoch} mean_loss={loss:.6f}",
                      flush=True)
            # every rank gathers sharded or sliced parameters and moments (a
            # collective) before rank 0's evaluation and writes
            host = state_mod.host_state(trainer.state) if sharded else None
            if sharded:
                eval_model.load_state_dict(host["params"], strict=True)
            # the reference evaluates every epoch, unconditionally
            # (main.py:250-262; --do_eval is its eval-only-and-exit flag);
            # the ranks encode, rank 0 scores
            res = evaluator.evaluate(test_loader,
                                     multi_sentence=multi_sentence,
                                     cut_off_points=cut_offs)
            r1 = res["R1"] if rank == 0 else 0.0
            # ties update best (reference main.py:257 `best_R1 <= R1`): the
            # first eval always writes ckpt_best, later epochs win ties
            is_best = r1 >= best_r1
            if is_best:
                best_r1, best_epoch = r1, epoch
            if rank == 0:
                state_mod.save_checkpoint(cfg.output_dir, trainer.state,
                                          epoch, best_r1, is_best=is_best,
                                          host=host)
                state_mod.export_torch_checkpoint(
                    eval_model, os.path.join(cfg.output_dir, "ckpt.pth.tar"),
                    epoch=epoch, global_step=gstep, best_r1=best_r1)
            # the other ranks wait here while rank 0 evaluates and writes
            process_barrier(f"epoch_{epoch}_done")
    finally:
        if trainer.metric_writer is not None:
            trainer.metric_writer.close()
    logger.info("The best R1 is: %.4f, best_epoch=%d", best_r1, best_epoch)
    return best_r1


if __name__ == "__main__":
    main()
