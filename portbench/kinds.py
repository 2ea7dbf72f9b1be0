"""The runners of the traffic kinds.

`train`: the recipe's training, as `main` builds it: the data layer from
`data/registry.py` over a `.fstore` (`FrameStoreClipDataset`, uint8
frames normalised on the card, pinned batches from `BatchLoader`), a
`Trainer` over the program's `CLIP4Clip`, and `Trainer.train_epoch` over
the batches, closed loop: the next step starts when the trainer asks for
its batch.  One trainer is built; its first three steps (on batches that
all differ) are the ones the reference follows; `warmup_steps` more warm
the window's shapes; the window takes whole steps until `--seconds` have
passed (traced: `trace_steps` steps), then reads the loss back and
synchronises.  `train_clips_per_s` is the clips of all steps in the
window over its seconds.

`encode`: the gallery encode, as `serve/cli.py build` runs it:
`RetrievalEngine.embed_video_batches` over the gallery's pinned batches,
one pass a call, vectors read back to the host; passes repeat until
`--seconds` have passed (traced: one pass).  `encode_clips_per_s` is the
clips of all passes over the window's seconds.

`train_ddp`: the same training on each of the traffic's `ranks`, one
process a card (`ddp.py` starts them; the traffic's `flags` name the data
extent), as `torchrun` runs the program: its own process group, loader
shard, DDP wrapper and global-batch loss.  Set-up, the first three steps
and the warm-up are the `train` runner's on every rank; rank 0 times the
warm-up and sends every rank the window's step count, ceil(`--seconds`
over its step time) (traced: `trace_steps`).  The ranks start and end the
window at a barrier once their cards are synchronised; rank 0's clock
times it.  Then each rank frees the program's state and sends rank 0 its
kept batches and readings; rank 0 follows the global batches with the
reference on its card.  `ddp_train_clips_per_s` is the global batch's
clips of all steps over rank 0's window seconds.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import List

from . import compare, synth, weights
from .harness import (_NOSPAN, CACHE, Window, forbidden_modules, free,
                      load_weights, peak_bytes, sync)


class Phases:
    """Host seconds of each stage of set-up, for standard error."""

    def __init__(self):
        self.t, self.done = time.time(), []

    def mark(self, name: str) -> None:
        now = time.time()
        self.done.append((name, now - self.t))
        self.t = now


class LossLog:
    """A `metric_writer` for the trainer that keeps each displayed step's
    loss."""

    def __init__(self):
        self.losses: List[float] = []

    def log(self, scalars, step):
        self.losses.append(scalars["train/sim_loss"]
                           + scalars["train/cluster_loss"])


class Feed:
    """The loader's batches, epoch after epoch, as the trainer asks for
    them: each wait timed on the host clock (a `portbench.data_wait` span
    of the window, `window`, when tracing), the first `keep` batches kept
    for the reference."""

    def __init__(self, loader, sampler, keep: int):
        self.loader, self.sampler = loader, sampler
        self.epoch, self.keep = 0, keep
        self.window = None
        sampler.set_epoch(0)
        self._it = iter(loader)
        self.kept, self.waits = [], []

    def _next(self):
        t = time.perf_counter()
        with (self.window.span("data_wait") if self.window is not None
              else _NOSPAN):
            try:
                batch = next(self._it)
            except StopIteration:
                self.epoch += 1
                self.sampler.set_epoch(self.epoch)
                self._it = iter(self.loader)
                batch = next(self._it)
        self.waits.append(time.perf_counter() - t)
        if len(self.kept) < self.keep:
            self.kept.append(batch)
        return batch

    def take(self, n: int):
        for _ in range(n):
            yield self._next()

    def until(self, deadline: float = None, steps: int = None):
        """Batches while the host clock is before `deadline` (or for
        `steps` batches)."""
        n = 0
        while (steps is None or n < steps) and \
                (deadline is None or time.perf_counter() < deadline):
            n += 1
            yield self._next()

    def close(self):
        self._it.close()


@contextlib.contextmanager
def first_spectral_ids(into: list):
    """The medoid ids of the program's first spectral clustering call
    ([S*B, K], segment-major), appended to `into` on the host."""
    import centerclip_tpu_torch.ops.spectral as sp
    call = sp.batch_spectral_clustering

    def record(*a, **kw):
        out = call(*a, **kw)
        if not into:
            into.append(out[1].long().cpu())
        return out
    sp.batch_spectral_clustering = record
    try:
        yield
    finally:
        sp.batch_spectral_clustering = call


class TrainSetUp:
    """Set-up of a training cell: the data, the program's model with the
    benchmark's weights, one `Trainer`, the loader's feed, and the first
    three steps with the program's numbers read between them (`prog`:
    each step's loss, step 1's clipped gradient from Adam's first moment,
    each leaf's change after step 3; where the plan clusters spectrally,
    `ids`: step 1's medoid ids of the first cluster layer, clip-major)."""

    def __init__(self, cell, seed, device):
        from centerclip_tpu_torch.data.registry import DATALOADER_DICT
        from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
        from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
        from centerclip_tpu_torch.train.loop import Trainer
        from .reference.model import part_norms

        self.cell, self.seed, self.device = cell, seed, device
        self.phases = phases = Phases()
        t, s = cell.traffic, cell.shapes
        self.data = os.path.join(CACHE, "data", t["dataset"])
        paths = synth.ensure_msrvtt(self.data, t["videos"], s.frames,
                                    s.resolution, t["captions_per_clip"])
        phases.mark("data")
        self.cfg = cfg = cell.run_config(seed, paths)
        self.loader, _, sampler = DATALOADER_DICT[cfg.data.datatype][
            "train"](cfg, SimpleTokenizer(), device=device)
        self.total_steps = len(self.loader) * cfg.epochs
        phases.mark("loader")
        self.model = CLIP4Clip(cfg.model, device=device, seed=seed)
        phases.mark("model")
        load_weights(self.model, weights.make(s, seed, device))
        phases.mark("weights")
        self.trainer = Trainer(cfg, self.model, total_steps=self.total_steps)
        self.feed = Feed(self.loader, sampler, keep=3)
        phases.mark("trainer")
        opt = self.trainer.optimizer
        log = LossLog()
        self.trainer.metric_writer = log
        self.before = compare.spectral_before(s)
        ids = []
        with (first_spectral_ids(ids) if self.before is not None
              else contextlib.nullcontext()):
            self.trainer.train_epoch(0, self.feed.take(1), n_display=1)
        self.ids = None
        if ids:
            S = next(p for p in s.plan if p is not None).frames_out
            self.ids = ids[0].reshape(S, -1, ids[0].shape[-1]).transpose(
                0, 1).reshape(ids[0].shape)
        self.layer = {}
        beta1 = opt.cfg.beta1
        self.prog = {"grad": part_norms(
            (n, m / (1.0 - beta1)) for n, m in zip(opt.names, opt.exp_avg))}
        self.trainer.train_epoch(0, self.feed.take(2), n_display=1)
        W0 = weights.make(s, seed, device)
        self.prog["change"] = part_norms(
            (n, p.detach() - W0[n]) for n, p in zip(opt.names, opt.params))
        self.prog["losses"] = list(log.losses)
        del W0
        self.trainer.metric_writer = None
        phases.mark("first steps")

    def close(self):
        """Free the program's state; the kept batches stay, held to the
        data set (`data_rows_wrong`)."""
        self.release()
        self.check_rows()

    def release(self):
        """Free the program's state; the kept batches stay."""
        self.kept = self.feed.kept
        self.feed.close()
        del self.trainer, self.model, self.loader, self.feed
        free(self.device)

    def check_rows(self):
        t = self.cell.traffic
        self.data_rows_wrong = synth.wrong_rows(
            self.kept, self.data, t["videos"], t["captions_per_clip"],
            self.cfg.data.max_words)

    def numbers(self, ref: dict) -> dict:
        """The program's numbers against the reference's steps `ref`."""
        spectral = ({} if self.before is None else
                    compare.cluster_numbers(self.cluster_layer()))
        return {**compare.train_numbers(self.prog, ref, self.before),
                **spectral, "data_rows_wrong": self.data_rows_wrong}

    def cluster_layer(self, precision: str = None) -> dict:
        """The first spectral cluster layer of step 1's batch, judged in
        the fp32 reference (`reference/spectral.layer_readings`): the
        program's medoid ids, or with `precision` the reference's own
        ids at that precision."""
        if precision in self.layer:
            return self.layer[precision]
        import torch
        from .reference import model as M
        from .reference import spectral
        from .reference.train import _batch_to
        M.strict_fp32()
        s, chunk = self.cell.shapes, self.cell.traffic["reference_chunk"]
        W0 = weights.make(s, self.seed, self.device)
        video = _batch_to(self.kept[0], self.device)[1]
        X, spec = spectral.first_tokens(W0, s, video, chunk)
        ids = self.ids
        if precision is not None:
            other, _ = spectral.first_tokens(W0, s, video, chunk,
                                             M.Numerics(precision))
            ids = spectral.medoids(other, spec, s.iter_limit, M.kmedoids)
            del other
        if ids is None:                 # never clustered: reads inf
            ids = torch.empty((0, spec.k), dtype=torch.long)
        self.layer[precision] = out = spectral.layer_readings(
            X, spec, ids, s.iter_limit, M.kmedoids)
        del W0, X, video
        free(self.device)
        return out

    def reference(self, precision="fp32", rows=None) -> dict:
        """The reference's three steps from the same weights on the kept
        batches (`rows`: those rows of each batch only)."""
        from .reference import train as ref_train
        from .reference.model import Numerics
        W0 = weights.make(self.cell.shapes, self.seed, self.device)
        out = ref_train.train_steps(
            W0, self.cell.shapes, self.kept, self.cell.config["optim"],
            self.total_steps, self.cell.config["freeze_layer_num"],
            num=Numerics(precision),
            chunk=self.cell.traffic["reference_chunk"], rows=rows)
        del W0
        free(self.device)
        return out


def run_train(cell, seed, seconds, trace, device, start) -> dict:
    setup = TrainSetUp(cell, seed, device)
    t, cfg, feed = cell.traffic, setup.cfg, setup.feed
    setup.trainer.train_epoch(0, feed.take(t["warmup_steps"]),
                             n_display=cfg.n_display)
    setup.phases.mark("warm-up")
    waits0 = len(feed.waits)
    with Window(device, trace, os.path.join(CACHE, "trace",
                                            cell.name + ".json")) as win:
        setup_s = time.time() - start
        feed.window = win
        it = (feed.until(steps=t["trace_steps"]) if trace else
              feed.until(deadline=win.t0 + seconds))
        mean_loss, _ = setup.trainer.train_epoch(feed.epoch, it,
                                                n_display=cfg.n_display)
    steps = len(feed.waits) - waits0
    waits = feed.waits[waits0:]
    peak = peak_bytes(device, cell.chips)
    setup.close()
    ref = setup.reference()
    ctx = {"shapes": cell.shapes, "batch": cfg.batch_size, "units": steps,
           "training": True, "remat": cfg.model.remat,
           "frozen_stem": cfg.freeze_layer_num >= 0, "counts": win.counts,
           "data_wait_s": waits, "chips": cell.chips, "device": device}
    if trace:
        ctx["trace"] = win.read()
    return {"numbers": setup.numbers(ref),
            "e2e": {"train_clips_per_s": steps * cfg.batch_size / win.seconds,
                    "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s},
            "attempted": steps,
            "failed": 0 if math.isfinite(mean_loss) else steps,
            "peak": peak, "ctx": ctx, "phases": setup.phases.done}


class RankSetUp(TrainSetUp):
    """`TrainSetUp` on one rank of a multi-rank cell (`ranks`: a
    `ddp.Ranks`).  At `close` each rank sends rank 0 its kept batches, its
    shards of the first three global batches, with `info`; rank 0 joins
    them rank by rank, as the program's all-gather orders the global
    batch, and holds the joined batches to the data set: `data_rows_wrong`,
    and `data_rows_repeated`, the rows that another rank's shard, or its
    own, already held."""

    def __init__(self, cell, seed, device, ranks):
        self.ranks = ranks
        super().__init__(cell, seed, device)

    def close(self, info: dict = None):
        """Rank 0: every rank's `info` in rank order; else None."""
        self.release()
        got = self.ranks.gather({"kept": self.kept, **(info or {})})
        if got is None:
            return None
        self.kept = [synth.join_rows([g["kept"][i] for g in got])
                     for i in range(len(self.kept))]
        self.check_rows()
        self.data_rows_repeated = synth.repeated_rows(self.kept)
        return got

    def numbers(self, ref: dict) -> dict:
        return {**super().numbers(ref),
                "data_rows_repeated": self.data_rows_repeated}


def run_train_ddp(cell, seed, seconds, trace, device, start) -> dict:
    """One rank's run (module docstring); None on all ranks but 0."""
    import torch
    from .ddp import Ranks
    ranks = Ranks()
    setup = RankSetUp(cell, seed, device, ranks)
    t, cfg, feed = cell.traffic, setup.cfg, setup.feed
    sync(device)
    t0 = time.perf_counter()
    setup.trainer.train_epoch(0, feed.take(t["warmup_steps"]),
                             n_display=cfg.n_display)
    sync(device)
    step_s = (time.perf_counter() - t0) / t["warmup_steps"]
    steps = t["trace_steps"] if trace else ranks.broadcast(
        math.ceil(seconds / step_s) if ranks.rank == 0 else None)
    setup.phases.mark("warm-up")
    waits0 = len(feed.waits)
    path = os.path.join(CACHE, "trace", f"{cell.name}.{ranks.rank}.json")
    with Window(device, trace, path, meet=ranks.barrier) as win:
        setup_s = time.time() - start
        feed.window = win
        mean_loss, _ = setup.trainer.train_epoch(
            feed.epoch, feed.until(steps=steps), n_display=cfg.n_display)
    done = len(feed.waits) - waits0
    waits = feed.waits[waits0:]
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    tr = win.read() if trace else None
    got = setup.close({"steps": done, "peak": peak,
                       "finite": math.isfinite(mean_loss),
                       "busy_s": tr.busy_s() if trace else None,
                       "loaded": forbidden_modules()})
    if got is None:
        return None
    if {g["steps"] for g in got} != {done}:
        raise RuntimeError(f"the ranks took {[g['steps'] for g in got]} "
                           "steps in the window")
    ref = setup.reference()
    peak = max(g["peak"] for g in got)
    ctx = {"shapes": cell.shapes, "batch": cfg.batch_size, "units": done,
           "training": True, "remat": cfg.model.remat,
           "frozen_stem": cfg.freeze_layer_num >= 0, "counts": win.counts,
           "data_wait_s": waits, "chips": cell.chips, "device": device}
    if trace:
        ctx["trace"] = tr
        ctx["busy_s"] = sum(g["busy_s"] for g in got) / len(got)
    return {"numbers": setup.numbers(ref),
            "e2e": {"ddp_train_clips_per_s": done * cfg.batch_size
                    / win.seconds,
                    "train_peak_gib": peak / 2 ** 30, "setup_s": setup_s},
            "attempted": done,
            "failed": 0 if all(g["finite"] for g in got) else done,
            "peak": peak, "ctx": ctx, "phases": setup.phases.done,
            "loaded": sorted({m for g in got for m in g["loaded"]})}


def encode_reference(cell, seed, gallery, device, precision="fp32"):
    """The reference's gallery vectors [n, E] (float64 numpy) of the
    gallery's clips from the same weights."""
    import torch
    from .reference import train as ref_train
    from .reference.model import Numerics
    s = cell.shapes
    W0 = weights.make(s, seed, device)
    ref = torch.cat([ref_train.encode(W0, s, b["video"], b["video_mask"],
                                      num=Numerics(precision),
                                      chunk=cell.traffic["reference_chunk"])
                     for b in gallery]).double().cpu().numpy()
    del W0
    free(device)
    return ref


def run_encode(cell, seed, seconds, trace, device, start) -> dict:
    import numpy as np
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    from centerclip_tpu_torch.serve.engine import RetrievalEngine

    t, s = cell.traffic, cell.shapes
    phases = Phases()
    cfg = cell.run_config(seed)
    gallery = synth.gallery(t["clips"], s.frames, s.resolution,
                            cfg.batch_size_val, seed, device)
    phases.mark("gallery")
    model = CLIP4Clip(cfg.model, device=device, seed=seed)
    phases.mark("model")
    load_weights(model, weights.make(s, seed, device))
    engine = RetrievalEngine(model, device=device)
    phases.mark("weights")
    engine.embed_video_batches(gallery[:t["warmup_batches"]])
    phases.mark("warm-up")

    passes = []
    with Window(device, trace, os.path.join(CACHE, "trace",
                                            cell.name + ".json")) as win:
        setup_s = time.time() - start
        deadline = win.t0 + seconds
        while not passes or (not trace and time.perf_counter() < deadline):
            passes.append(engine.embed_video_batches(gallery))
    clips = len(passes) * t["clips"]
    peak = peak_bytes(device, cell.chips)
    del engine, model
    free(device)

    ref = encode_reference(cell, seed, gallery, device)
    ctx = {"shapes": s, "batch": cfg.batch_size_val,
           "units": len(passes) * len(gallery), "training": False,
           "remat": cfg.model.remat, "frozen_stem": True,
           "counts": win.counts, "chips": cell.chips, "device": device}
    if trace:
        ctx["trace"] = win.read()
    failed = int(sum((~np.isfinite(p).all(axis=1)).sum() for p in passes))
    return {"numbers": compare.encode_numbers(passes, ref),
            "e2e": {"encode_clips_per_s": clips / win.seconds,
                    "setup_s": setup_s},
            "attempted": clips, "failed": failed, "peak": peak, "ctx": ctx,
            "phases": phases.done}


KINDS = {"train": run_train, "encode": run_encode,
         "train_ddp": run_train_ddp}
