# coding=utf-8
"""The port's span recorder (`utils/spans.py`) and its spans in the trainer,
the cluster layer, the loader and the gallery encode, on the CPU."""
import threading
import tracemalloc
import weakref

import numpy as np
import pytest
import torch

from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.data import loader
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.serve import RetrievalEngine
from centerclip_tpu_torch.train import Trainer, loop
from centerclip_tpu_torch.utils import spans

ARCH = "tiny-port-spans"
T, RES, VOCAB, CTX = 4, 24, 100, 12
TINY = dict(embed_dim=32, image_resolution=RES, vision_layers=2,
            vision_width=64, vision_patch_size=8, vision_heads=4,
            context_length=CTX, vocab_size=VOCAB, transformer_width=64,
            transformer_heads=4, transformer_layers=2)


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """The tiny arch registered, the recorder off and empty around each
    test."""
    monkeypatch.setitem(port_config.CLIP_ARCHS, ARCH, TINY)
    spans.off()
    spans.take()
    yield
    spans.off()
    spans.take()


def run_config(**over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(5, 5), target_frames_blocks=(T, T // 2),
              cluster_embedding=True, lr=1e-3, warmup_proportion=0.0)
    kw.update(over)
    return port_config.make_run_config(**kw)


def make_batch(seed, n=3):
    g = np.random.default_rng(seed)
    ids = g.integers(1, VOCAB - 2, size=(n, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[:, -1] = VOCAB - 1
    return {"input_ids": ids, "attention_mask": np.ones((n, CTX), np.int32),
            "video": g.integers(0, 256, (n, 1, T, 3, RES, RES),
                                dtype=np.uint8),
            "video_mask": np.ones((n, T), np.int32)}


def by_name(records, name):
    return [r for r in records if r.name == name]


def inside(inner, outer):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


# ---------------------------------------------------------------- recorder
def _allocated(loop, n=10000):
    """(net, peak) bytes that tracemalloc sees `loop(n)` allocate."""
    loop(10)
    tracemalloc.start()
    try:
        loop(10)
        tracemalloc.reset_peak()
        before, _ = tracemalloc.get_traced_memory()
        loop(n)
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return after - before, peak - before


def test_off_the_recorder_hands_out_the_shared_no_op_and_allocates_nothing():
    assert not spans.enabled()
    assert spans.span("train.step", step=1) is spans.NOSPAN
    assert spans.span("cluster") is spans.NOSPAN

    def bare(n):
        for _ in range(n):
            with spans.NOSPAN:
                with spans.NOSPAN:
                    pass

    def spanned(n):
        for _ in range(n):
            with spans.span("train.step", step=7):
                with spans.span("cluster", algo="kmediods++", segments=6):
                    pass

    base_net, base_peak = _allocated(bare)
    net, peak = _allocated(spanned)
    assert net == base_net == 0
    assert peak <= base_peak
    assert spans.take() == []


def test_on_the_recorder_keeps_nesting_parents_threads_and_args():
    spans.on()
    assert spans.enabled()
    with spans.span("outer", step=3) as outer:
        assert outer is not spans.NOSPAN
        with spans.span("inner"):
            pass

        def worker():
            with spans.span("elsewhere", ready=True):
                pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    spans.off()
    with spans.span("after"):
        pass
    recs = spans.take()
    assert [r.name for r in recs] == ["inner", "elsewhere", "outer"]
    inner, elsewhere, outer = recs
    assert (inner.parent, elsewhere.parent, outer.parent) == \
        ("outer", None, None)
    assert inside(inner, outer) and inside(elsewhere, outer)
    me = threading.get_native_id()
    assert inner.tid == outer.tid == me != elsewhere.tid
    assert (outer.args, inner.args, elsewhere.args) == \
        ({"step": 3}, {}, {"ready": True})
    assert spans.take() == []


def test_a_span_is_recorded_when_its_block_raises():
    spans.on()
    with pytest.raises(ValueError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise ValueError("x")
    with spans.span("next"):
        pass
    recs = spans.take()
    assert [(r.name, r.parent) for r in recs] == \
        [("inner", "outer"), ("outer", None), ("next", None)]


# ------------------------------------------------------------ span sites
def test_a_trainer_step_holds_h2d_forward_backward_update_in_order():
    run = run_config()
    trainer = Trainer(run, CLIP4Clip(run.model, device="cpu", seed=0),
                      total_steps=4)
    spans.on()
    trainer.train_epoch(0, [make_batch(0), make_batch(1)], n_display=1)
    recs = spans.take()
    steps = by_name(recs, "train.step")
    assert [s.args for s in steps] == [{"step": 1}, {"step": 2}]
    for step in steps:
        phases = sorted((r for r in recs if r.parent == "train.step"
                         and inside(r, step)), key=lambda r: r.start_ns)
        assert [r.name for r in phases] == [
            "train.h2d", "train.forward", "train.backward", "train.update"]
        for a, b in zip(phases, phases[1:]):
            assert a.end_ns <= b.start_ns
        forward = phases[1]
        clusters = [r for r in by_name(recs, "cluster") if inside(r, step)]
        assert clusters and all(inside(c, forward) and
                                c.parent == "train.forward" for c in clusters)
        assert {c.args["algo"] for c in clusters} == {"kmediods++"}
        assert {c.args["segments"] for c in clusters} == {3 * T // 2}


def test_the_step_frees_the_cards_copy_of_the_batch_before_the_backward(
        monkeypatch):
    """The spans split the step's copy from its forward; the copy's
    tensors must still be gone before the backward, whose peak memory
    they would raise."""
    run = run_config()
    trainer = Trainer(run, CLIP4Clip(run.model, device="cpu", seed=0),
                      total_steps=4)
    copies, freed = [], []

    def to_device(batch, device):
        out = loop.shard_batch(batch, device)
        copies.append(weakref.ref(out["video"]))
        return out

    def backward(self, *args, **kwargs):
        freed.append(copies[-1]() is None)
        return tensor_backward(self, *args, **kwargs)
    tensor_backward = torch.Tensor.backward
    monkeypatch.setattr(loop, "batch_to_device", to_device)
    monkeypatch.setattr(torch.Tensor, "backward", backward)
    trainer.train_epoch(0, [make_batch(0), make_batch(1)], n_display=1)
    assert freed == [True, True]


def test_accumulated_micro_batches_step_once_in_a_span():
    run = run_config(optim="BertAdam", gradient_accumulation_steps=2)
    trainer = Trainer(run, CLIP4Clip(run.model, device="cpu", seed=0),
                      total_steps=4)
    spans.on()
    trainer.train_epoch(0, [make_batch(s) for s in range(4)], n_display=1)
    recs = spans.take()
    steps = by_name(recs, "train.step")
    assert [s.args["step"] for s in steps] == [1, 2]
    assert len(by_name(recs, "train.forward")) == 4
    assert len(by_name(recs, "train.update")) == 2


def _gallery():
    out = []
    for seed, n in ((0, 4), (1, 4), (2, 3)):
        b = make_batch(seed, n)
        out.append({"video": b["video"], "video_mask": b["video_mask"]})
    return out


def test_embed_video_batches_spans_each_batch_and_one_readback():
    run = run_config()
    engine = RetrievalEngine(CLIP4Clip(run.model, device="cpu", seed=0),
                             device="cpu")
    spans.on()
    emb = engine.embed_video_batches(_gallery())
    recs = spans.take()
    assert emb.shape[0] == 11
    batches = by_name(recs, "encode.batch")
    assert [b.args["rows"] for b in batches] == [4, 4, 3]
    assert len(by_name(recs, "encode.readback")) == 1
    for name in ("encode.h2d", "encode.forward"):
        got = by_name(recs, name)
        assert len(got) == 3
        assert all(r.parent == "encode.batch" for r in got)
        assert all(any(inside(r, b) for b in batches) for r in got)
    assert all(c.parent == "encode.forward" for c in by_name(recs, "cluster"))


class _Toy:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"input_ids": np.full((1, 4), i, np.int32),
                "video": np.full((1, 2, 3, 4, 4), i, np.uint8),
                "video_mask": np.ones((1, 2), np.int32)}


class _Batched(_Toy):
    """A dataset with the loader's batched fast path (`get_batch`)."""

    def get_batch(self, idx, pin_memory=False):
        return loader.collate([self[int(i)] for i in idx])


@pytest.mark.parametrize("dataset,threads", [(_Batched(12), 0),
                                             (_Toy(12), 2)],
                         ids=["fast_path", "threaded"])
def test_the_loader_spans_its_waits_and_gathers(dataset, threads):
    spans.on()
    batches = list(loader.BatchLoader(dataset, batch_size=3,
                                      num_threads=threads))
    recs = spans.take()
    assert len(batches) == 4
    waits, gathers = by_name(recs, "data.wait"), by_name(recs, "data.gather")
    assert len(gathers) == 4
    # the threaded path waits once more, for the producer's end of epoch
    assert len(waits) == 4 + (threads > 0)
    assert all(isinstance(w.args["ready"], bool) for w in waits)
    if threads:
        assert all(w.args["depth"] >= 0 for w in waits)
    me = threading.get_native_id()
    assert all(w.tid == me for w in waits)
    assert all(g.tid != me for g in gathers)
