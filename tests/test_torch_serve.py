# coding=utf-8
"""The port's serving path (flat VideoIndex, RetrievalEngine) against brute
force and against the JAX package, on the CPU."""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.serve import RetrievalEngine as JaxEngine
from centerclip_tpu.serve import VideoIndex as JaxIndex
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import state_dict_from_jax_params
from centerclip_tpu_torch.serve import RetrievalEngine, VideoIndex, load_index

ARCH = "tiny-port-serve"
T, RES, CTX = 4, 24, 16
TINY = dict(embed_dim=32, image_resolution=RES, vision_layers=2,
            vision_width=64, vision_patch_size=8, vision_heads=4,
            context_length=CTX, vocab_size=49408, transformer_width=64,
            transformer_heads=4, transformer_layers=2)
jax_config.CLIP_ARCHS[ARCH] = TINY
port_config.CLIP_ARCHS[ARCH] = TINY
QUANT = ["float32", "bfloat16", "int8"]


def _emb(seed, n=37, d=32):
    g = np.random.default_rng(seed)
    return (g.standard_normal((n, d)).astype(np.float32),
            [f"vid{i}" for i in range(n)])


@pytest.mark.parametrize("quantize", QUANT)
def test_index_topk_matches_bruteforce_and_jax(quantize):
    emb, ids = _emb(0)
    q = np.random.default_rng(1).standard_normal((5, 32)).astype(np.float32)
    index = VideoIndex(emb, ids, quantize=quantize, device="cpu")
    scores, idx = index.search(q, k=7)
    assert scores.shape == (5, 7) and idx.shape == (5, 7)
    assert idx.max() < len(ids)                      # padding never escapes
    en = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    ref = qn @ en.T
    np.testing.assert_array_equal(idx[:, 0], np.argmax(ref, axis=1))
    # bf16 operands / int8 codes: scores are cosines to ~1e-2
    np.testing.assert_allclose(scores, np.take_along_axis(ref, idx, axis=1),
                               rtol=0, atol=2e-2)
    j_scores, j_idx = JaxIndex(emb, ids, quantize=quantize).search(q, k=7)
    np.testing.assert_array_equal(idx, j_idx)
    # same bf16-rounded operands, fp32 sums taken in another order
    np.testing.assert_allclose(scores, j_scores, rtol=1e-5, atol=1e-6)


def test_index_k_clamped_and_single_query():
    emb, ids = _emb(2, n=6)
    index = VideoIndex(emb, ids, device="cpu")
    scores, idx = index.search(np.ones(32, np.float32), k=100)
    assert scores.shape == (1, 6) and sorted(idx[0].tolist()) == list(range(6))
    with pytest.raises(ValueError):
        index.search(np.ones((1, 32), np.float32), k=0)


@pytest.mark.parametrize("quantize", QUANT)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_crosses_between_packages(tmp_path, quantize, writer):
    emb, ids = _emb(3, n=19)
    path = str(tmp_path / "gallery.npz")
    port = VideoIndex(emb, ids, quantize=quantize, device="cpu")
    jidx = JaxIndex(emb, ids, quantize=quantize)
    if writer == "port":
        port.save(path)
        other = JaxIndex.load(path)
        codes = np.asarray(other._codes_host[:19], np.float32)
        mine = port._codes[:19].float().numpy()
    else:
        jidx.save(path)
        other = load_index(path, device="cpu")
        codes = other._codes[:19].float().numpy()
        mine = np.asarray(jidx._codes_host[:19], np.float32)
    np.testing.assert_array_equal(codes, mine)
    assert other.video_ids == ids and other.quantize == quantize
    q = np.random.default_rng(4).standard_normal((3, 32)).astype(np.float32)
    np.testing.assert_array_equal(other.search(q, k=10)[1],
                                  port.search(q, k=10)[1])


def _engines():
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(5, 5), target_frames_blocks=(T, T // 2))
    jcfg = jax_config.make_run_config(**kw).model
    cfg = port_config.make_run_config(**kw).model
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = JaxCLIP4Clip(jcfg)
    ids = np.ones((2, CTX), np.int32)
    params = jmodel.init(
        jax.random.PRNGKey(0), input_ids=ids,
        video=np.zeros((2, 1, T, 3, RES, RES), np.float32),
        video_mask=np.ones((2, T), np.int32), training=True)["params"]
    model = CLIP4Clip(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    return JaxEngine(jmodel, params), RetrievalEngine(model, device="cpu")


def _batches():
    out = []
    for seed, n in ((0, 4), (1, 4), (2, 3)):              # ragged tail
        g = np.random.default_rng(seed)
        vmask = np.ones((n, T), np.int32)
        vmask[0, -1] = 0
        out.append({"video": g.integers(0, 256, (n, 1, T, 3, RES, RES),
                                        dtype=np.uint8),
                    "video_mask": vmask})
    return out


def test_engine_search_matches_jax_engine():
    jeng, eng = _engines()
    vids = [f"v{i}" for i in range(11)]
    texts = ["a cat sitting on a mat", "a dog playing in the park",
             "people dancing", "a man is cooking pasta in a kitchen"]
    for e in (jeng, eng):
        e.build_index(iter(_batches()), vids, quantize="int8")
    np.testing.assert_allclose(eng.encode_texts(texts),
                               jeng.encode_texts(texts), rtol=2e-4,
                               atol=2e-5)
    ref = jeng.search(texts, k=5)
    out = eng.search(texts, k=5)
    for r, o in zip(ref, out):
        assert [h["video_id"] for h in o] == [h["video_id"] for h in r]
        # scores are logits (cosine x exp(logit_scale) ~ 14.3) of a bf16
        # score matmul over int8 codes
        np.testing.assert_allclose([h["score"] for h in o],
                                   [h["score"] for h in r], rtol=0,
                                   atol=2e-2)
    assert len({h["video_id"] for h in out[0]}) == 5


def test_engine_gallery_matches_model_similarity():
    _, eng = _engines()
    batches = _batches()
    gallery = eng.embed_video_batches(iter(batches))
    m = eng.model
    for b, lo in zip(batches, (0, 4, 8)):
        vm = m.video_mask_after_cluster(torch.from_numpy(b["video_mask"]))
        vis = m.get_visual_output(torch.from_numpy(b["video"]), vm)
        np.testing.assert_allclose(gallery[lo:lo + len(vm)],
                                   m.pooled_video(vis, vm).detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_engine_needs_a_gpu_unless_told_cpu(monkeypatch):
    _, eng = _engines()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        RetrievalEngine(eng.model)
    with pytest.raises(RuntimeError):
        VideoIndex(*_emb(5, n=4))
    with pytest.raises(RuntimeError):
        eng.search_token_ids(np.ones((1, CTX), np.int32))   # no index yet
