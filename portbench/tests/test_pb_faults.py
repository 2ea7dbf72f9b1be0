"""A run with the timed path broken underneath comes out not correct.

The harness's look for a chip is skipped (device "cpu"); everything else
of a run is driven: set-up, the first steps, the window, the reference,
the comparison.  Medoids are pinned on both sides, and the limits are
set for this tiny cell from its own sound runs over seven seeds (loss
0.0006-0.0072; gradient, worst leaf 0.012-0.033, text median
0.0017-0.0094; change, worst 0.007-0.025, text median 0.0013-0.0042,
vision median 0.0008-0.0035; with spectral clustering the blocks before
the cluster layer's median change 0.0006-0.0030, seven seeds; the cluster
layer's cost excess 0 with pinned medoids, -0.013 to 0.006 on three
seeds without)."""
import time

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny

LIMITS = {"loss_gap": 0.03, "grad_gap": 0.1, "text_grad_gap_median": 0.03,
          "update_gap": 0.08, "text_update_gap_median": 0.015,
          "vision_update_gap_median": 0.008, "data_rows_wrong": 0,
          "vec_gap": 0.03, "pre_cluster_update_gap_median": 0.008,
          "identity_segments": 0, "cluster_cost_excess": 0.1}
# k-medoids, and spectral clustering with the tokens ~3 sigma apart
CONFIGS = pytest.mark.parametrize("config", [
    {}, {"algo": "spectral", "stream_scale": 0.5}], ids=["kmedoids",
                                                         "spectral"])


def run(kind, seed=7, **config):
    cell = tiny.cell(kind, limits=LIMITS, **config)
    return harness.run(cell, seed=seed, seconds=0.2, trace=False,
                       device="cpu", start=time.time())[0]


@CONFIGS
@pytest.mark.parametrize("kind", ["train", "encode"])
def test_a_sound_run_is_correct(tiny_env, pinned_medoids, kind, config):
    assert run(kind, **config)["correct"]


@CONFIGS
def test_a_step_that_returns_its_state_unchanged(tiny_env, pinned_medoids,
                                                 monkeypatch, config):
    from centerclip_tpu_torch.train.optim import GroupedAdam

    def step(self):
        self.step_count += 1
    monkeypatch.setattr(GroupedAdam, "step", step)
    res = run("train", **config)
    assert not res["correct"]
    assert res["checks"]["update_gap"]["value"] == pytest.approx(1.0)


@CONFIGS
def test_half_the_batch_left_out(tiny_env, pinned_medoids, monkeypatch,
                                 config):
    from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
    forward = CLIP4Clip.forward

    def half(self, input_ids=None, attention_mask=None, video=None,
             video_mask=None, training=False, generator=None):
        n = input_ids.shape[0] // 2
        return forward(self, input_ids[:n], attention_mask[:n], video[:n],
                       video_mask[:n], training, generator)
    monkeypatch.setattr(CLIP4Clip, "forward", half)
    res = run("train", **config)
    assert not res["correct"]
    assert res["checks"]["loss_gap"]["value"] > LIMITS["loss_gap"]


@pytest.mark.parametrize("fault", ["caption", "frame"])
def test_the_data_layer_hands_out_a_wrong_row(tiny_env, pinned_medoids,
                                              monkeypatch, fault):
    """A clip with another clip's caption, or a frame not the clip's,
    in every batch the trainer gets."""
    from centerclip_tpu_torch.data.fast_dataset import FrameStoreClipDataset
    get_batch = FrameStoreClipDataset.get_batch

    def broken(self, indices, pin_memory=False):
        b = get_batch(self, indices, pin_memory)
        if fault == "caption":
            b["input_ids"] = np.roll(np.asarray(b["input_ids"]), 1, axis=0)
        else:
            b["video"][0, 0, 1] = b["video"][0, 0, 0]
        return b
    monkeypatch.setattr(FrameStoreClipDataset, "get_batch", broken)
    res = run("train")
    assert not res["correct"]
    assert res["checks"]["data_rows_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_an_answer_altered_or_left_out(tiny_env, pinned_medoids,
                                       monkeypatch, fault):
    from centerclip_tpu_torch.serve.engine import RetrievalEngine
    embed = RetrievalEngine.embed_video_batches

    def broken(self, batches):
        out = embed(self, batches)
        if fault == "half":
            return out[: len(out) // 2]
        out = out.copy()
        out[3] = -out[3]
        return out
    monkeypatch.setattr(RetrievalEngine, "embed_video_batches", broken)
    res = run("encode")
    assert not res["correct"]
    assert res["checks"]["vec_gap"]["value"] > LIMITS["vec_gap"]


def test_medoids_drawn_at_random_in_the_cluster_layer(tiny_env):
    """Spectral clustering's answer altered where it is produced: each
    segment's medoids drawn at random (`control.solve_fault`), unpinned,
    on tokens ~3 sigma apart."""
    from portbench import control
    with control.solve_fault("random_medoids"):
        res = run("train", algo="spectral", stream_scale=0.5)
    assert not res["correct"]
    assert res["checks"]["cluster_cost_excess"]["value"] > \
        LIMITS["cluster_cost_excess"]
