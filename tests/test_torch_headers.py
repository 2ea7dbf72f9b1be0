# coding=utf-8
"""The port's similarity headers (seqTransf, tightTransf and its cross
model, seqLSTM's refusal) against the JAX package, on the CPU.

A tiny clustered CLIP4Clip on the `tiny-e2e` arch of tests/test_main_e2e.py
(2 + 2 blocks, embed 16, 4 frames of 32 x 32 at patch 16 -> 2 segments,
K = 3) is initialised by the JAX package with each header; its parameters
cross over through `state_dict_from_jax_params` and
`load_state_dict(strict=True)`.  Inputs come from numpy with a seed.  Every
fp32 comparison uses the budget of tests/test_torch_models.py, rtol 2e-4 /
atol 2e-5; losses rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import jax
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.serve import RetrievalEngine as JaxEngine
from centerclip_tpu.train import evaluate as jax_evaluate
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models import layers
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import (clip4clip_entries,
                                                 state_dict_from_jax_params)
from centerclip_tpu_torch.serve import RetrievalEngine
from centerclip_tpu_torch.train import Evaluator, loop

ARCH = "tiny-e2e"
T, RES, VOCAB, CTX = 4, 32, 49408, 12
TINY = dict(embed_dim=16, image_resolution=RES, vision_layers=2,
            vision_width=32, vision_patch_size=16, vision_heads=2,
            context_length=CTX, vocab_size=VOCAB, transformer_width=32,
            transformer_heads=2, transformer_layers=2)
# the same arch as tests/test_main_e2e.py's, in each package's table
jax_config.CLIP_ARCHS[ARCH] = TINY
port_config.CLIP_ARCHS[ARCH] = TINY

FP32 = dict(rtol=2e-4, atol=2e-5)
HEADERS = {"meanP": dict(sim_header="meanP"),
           "seqTransf": dict(sim_header="seqTransf"),
           "tightTransf": dict(sim_header="tightTransf",
                               cross_num_hidden_layers=2),
           "seqLSTM": dict(sim_header="seqLSTM")}


def config_kw(header, **over):
    kw = dict(clip_name=ARCH, max_frames=T, max_words=CTX,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(3, 3), target_frames_blocks=(T, T // 2),
              lr=1e-3, coef_lr=0.5, weight_decay=0.2, warmup_proportion=0.0,
              **HEADERS[header])
    kw.update(over)
    return kw


def make_batch(seed, n=3):
    g = np.random.default_rng(seed)
    ids = g.integers(1, 1000, size=(n, CTX)).astype(np.int32)
    ids[:, 0] = VOCAB - 2
    ids[np.arange(n), g.integers(3, CTX, n)] = VOCAB - 1     # EOT
    vmask = np.ones((n, T), np.int32)
    vmask[-1, -2:] = 0                   # the last clip's second segment
    return {"input_ids": ids, "attention_mask": np.ones((n, CTX), np.int32),
            "video": g.integers(0, 256, (n, 1, T, 3, RES, RES),
                                dtype=np.uint8),
            "video_mask": vmask}


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


_PAIRS = {}


def pair(header, **over):
    """(JAX model, its params, the port's model with those weights, port
    config) for a header; the JAX init is cached per header."""
    jrun = jax_config.make_run_config(**config_kw(header, **over))
    run = port_config.make_run_config(**config_kw(header, **over))
    assert dataclasses.asdict(run) == dataclasses.asdict(jrun)
    jmodel = JaxCLIP4Clip(jrun.model)
    if header not in _PAIRS:
        # a training forward materialises every header parameter; seqLSTM's
        # raises there, so its tree (the CLIP towers and the frame-position
        # table) is taken from a seqTransf init
        b = make_batch(0)
        init_model = JaxCLIP4Clip(jax_config.make_run_config(
            **config_kw(header if header != "seqLSTM" else "seqTransf")
        ).model)
        params = init_model.init(
            jax.random.PRNGKey(0), input_ids=b["input_ids"],
            video=b["video"].astype(np.float32), video_mask=b["video_mask"],
            training=True)["params"]
        _PAIRS[header] = jax.tree_util.tree_map(np.asarray, params)
    params = _PAIRS[header]
    model = CLIP4Clip(run.model, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, run.model),
                          strict=True)
    return jmodel, params, model, run


def _jax(jmodel, params, fn, *args):
    return np.asarray(jmodel.apply({"params": params}, *args, method=fn))


# ----------------------------------------------------------- the schema
@pytest.mark.parametrize("header,keys", [
    ("seqTransf", ["frame_position_embeddings.weight",
                   "transformerClip.resblocks.0.attn.in_proj_weight",
                   "transformerClip.resblocks.1.mlp.c_proj.bias"]),
    ("tightTransf", ["cross.embeddings.position_embeddings.weight",
                     "cross.transformer.resblocks.1.ln_2.weight",
                     "cross.pooler.ln_pool.bias", "cross.pooler.dense.weight",
                     "similarity_dense.weight", "similarity_dense.bias"])])
def test_header_keys_are_the_reference_schema(header, keys):
    run = port_config.make_run_config(**config_kw(header))
    model = CLIP4Clip(run.model, device="cpu")
    sd = model.state_dict()
    assert set(keys) <= set(sd)
    assert set(sd) == {k for _, k, _ in clip4clip_entries(run.model)}
    assert sd["similarity_dense.weight" if header == "tightTransf"
              else "frame_position_embeddings.weight"].dtype == torch.float32


# ------------------------------------------------------ modules alone
def test_cross_model_matches_jax():
    jmodel, params, model, _ = pair("tightTransf")
    g = np.random.default_rng(1)
    x = g.standard_normal((5, 4, 16)).astype(np.float32)
    ctype = np.zeros((5, 4), np.int32)
    mask = np.ones((5, 4), np.float32)
    mask[1, 3], mask[4, 2:] = 0, 0
    ref_h, ref_p = jmodel.apply({"params": params}, x, ctype, mask,
                                method=lambda m, *a: m.cross(*a))
    hidden, pooled = model.cross(t(x), t(ctype), t(mask))
    np.testing.assert_allclose(hidden.detach().numpy(), np.asarray(ref_h),
                               **FP32)
    np.testing.assert_allclose(pooled.detach().numpy(), np.asarray(ref_p),
                               **FP32)


def test_seq_transf_matches_jax():
    jmodel, params, model, _ = pair("seqTransf")
    g = np.random.default_rng(2)
    vis = g.standard_normal((4, 3, 16)).astype(np.float32)
    vmask = np.array([[1, 1, 1], [1, 1, 0], [1, 0, 0], [1, 1, 1]], np.int32)
    ref = _jax(jmodel, params, lambda m, v, vm: m._seq_transf(v, vm),
               vis, vmask)
    out = model.seq_transf(t(vis), t(vmask))
    np.testing.assert_allclose(out.detach().numpy(), ref, **FP32)


def test_header_blocks_run_the_plain_fp32_attention(monkeypatch):
    """The header and cross blocks take the plain `attention_plain` by
    their `fused=False`; only the towers' blocks reach the kernel
    wrapper."""
    _, _, model, _ = pair("tightTransf")
    calls = []
    real = layers.fused_attention

    def counting(qkv, *a):
        calls.append(qkv.shape[1])
        return real(qkv, *a)
    monkeypatch.setattr(layers, "fused_attention", counting)
    seq = torch.randn(2, 1, 16)
    vis = torch.randn(3, 2, 16)
    with torch.no_grad():
        model.cross_similarity(seq, vis, torch.ones(3, 2))
    assert calls == []
    assert all(not b.attn.fused for b in model.cross.transformer.resblocks)
    with torch.no_grad():
        model.get_sequence_output(t(make_batch(3)["input_ids"]).long())
    assert calls == [CTX] * 2            # the text tower's two blocks


@pytest.mark.parametrize("chunk", [2, 3])
def test_cross_similarity_chunked_equals_unchunked_and_jax(chunk):
    """5 text rows against 4 videos: chunks of 2 or 3 leave a ragged
    tail; every block must equal the unchunked scores and JAX's."""
    jmodel, params, model, run = pair("tightTransf")
    g = np.random.default_rng(3)
    seq = g.standard_normal((5, 1, 16)).astype(np.float32)
    vis = g.standard_normal((4, 2, 16)).astype(np.float32)
    vmask = np.array([[1, 1], [1, 0], [1, 1], [1, 1]], np.int32)
    ref = _jax(jmodel, params,
               lambda m, s, v, vm: m.cross_similarity(s, v, None, vm),
               seq, vis, vmask)
    with torch.no_grad():
        full = model.cross_similarity(t(seq), t(vis), t(vmask))
        model.cfg = dataclasses.replace(run.model, cross_chunk_size=chunk)
        chunked = model.cross_similarity(t(seq), t(vis), t(vmask))
    assert tuple(chunked.shape) == (5, 4)
    np.testing.assert_allclose(chunked.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(full.numpy(), ref, **FP32)


# ------------------------------------------------------ one training step
def _jax_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.mark.parametrize("header", ["seqTransf", "tightTransf"])
def test_loss_and_every_gradient_match_jax(header):
    jmodel, params, model, run = pair(header)
    batch = make_batch(4)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, input_ids=batch["input_ids"],
                           attention_mask=batch["attention_mask"],
                           video=batch["video"],
                           video_mask=batch["video_mask"], training=True,
                           rng=jax.random.PRNGKey(0))
        return out["loss"], out["sim_loss"]
    (jloss, jsim), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    out = model(**loop.batch_to_device(batch, torch.device("cpu")),
                training=True)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out["sim_loss"].detach()), float(jsim),
                               rtol=1e-5)
    named = dict(model.named_parameters())
    header_keys = 0
    for path, key, tf in clip4clip_entries(run.model):
        ref = _jax_leaf(jgrads, path)
        grad = named[key].grad
        if grad is None:          # tightTransf does not read logit_scale
            assert key == "clip.logit_scale" and not ref.any(), key
            continue
        header_keys += not key.startswith("clip.")
        np.testing.assert_allclose(grad.numpy(), ref.T if tf == "T" else ref,
                                   err_msg=key, **FP32)
    assert header_keys > 10
    assert float(named[next(k for k in named
                            if not k.startswith("clip."))].grad.abs().sum()) > 0


# ------------------------------------------------- evaluator and engine
@pytest.mark.parametrize("header", ["seqTransf", "tightTransf"])
def test_evaluator_matrix_matches_jax(header):
    jmodel, params, model, _ = pair(header)
    batches = [make_batch(10, n=4), make_batch(11, n=2)]
    ref = jax_evaluate.Evaluator(jmodel, params).evaluate(
        [dict(b) for b in batches])
    res = Evaluator(model).evaluate(batches)
    assert res["sim_matrix"].shape == ref["sim_matrix"].shape == (6, 6)
    np.testing.assert_allclose(res["sim_matrix"], ref["sim_matrix"], **FP32)
    for d in ("t2v", "v2t"):
        for k in ("R1", "R5", "R10", "MR", "MeanR"):
            assert res[d][k] == ref[d][k], (d, k)


def test_engine_pooled_vector_matches_jax_for_seq_transf():
    jmodel, params, model, _ = pair("seqTransf")
    batches = [{"video": b["video"], "video_mask": b["video_mask"]}
               for b in (make_batch(12, n=3), make_batch(13, n=2))]
    ref = JaxEngine(jmodel, params).embed_video_batches(iter(batches))
    eng = RetrievalEngine(model, device="cpu")
    got = eng.embed_video_batches(iter(batches))
    assert got.shape == (5, 16)
    np.testing.assert_allclose(got, ref, **FP32)
    # the header moved the vectors: meanP's pooling alone gives others
    vm = model.video_mask_after_cluster(t(batches[0]["video_mask"]))
    with torch.no_grad():
        plain = model.pooled_video(
            model.get_visual_output(t(batches[0]["video"]), vm), vm)
    assert np.abs(plain.numpy() - got[:3]).max() > 1e-3


@pytest.mark.parametrize("header", ["meanP", "seqTransf"])
def test_video_vector_is_the_engines_and_the_similaritys_video_side(header):
    """The engine's pooled vector and the loose similarity's video side
    are one model method, `video_vector`; under meanP a pooled [B, D]
    passes as it is (seqTransf needs the frames, as in the JAX package)."""
    _, _, model, _ = pair(header)
    batch = make_batch(14, n=3)
    got = RetrievalEngine(model, device="cpu").embed_video_batches(
        iter([{"video": batch["video"], "video_mask": batch["video_mask"]}]))
    vm = model.video_mask_after_cluster(t(batch["video_mask"]))
    seq = torch.from_numpy(np.random.default_rng(15).standard_normal(
        (4, 1, 16)).astype(np.float32))
    with torch.no_grad():
        visual = model.get_visual_output(t(batch["video"]), vm)
        vec = model.video_vector(visual, vm)
        logits = model.loose_similarity(seq, visual, vm)
    np.testing.assert_allclose(got, vec.numpy(), **FP32)
    scale = model.clip.logit_scale.exp().item()
    np.testing.assert_allclose(
        logits.numpy(), scale * (seq[:, 0] / seq[:, 0].norm(
            dim=-1, keepdim=True)).numpy() @ vec.numpy().T, **FP32)
    if header == "meanP":
        assert torch.equal(model.video_vector(vec, vm), vec)
    else:
        with pytest.raises(ValueError):
            model.video_vector(vec, vm)


@pytest.mark.parametrize("header", ["tightTransf", "seqLSTM"])
def test_engine_refuses_what_jax_refuses(header):
    jmodel, params, model, _ = pair(header)
    with pytest.raises(ValueError, match="cannot be served"):
        JaxEngine(jmodel, params)
    with pytest.raises(ValueError, match="cannot be served"):
        RetrievalEngine(model, device="cpu")


def test_seq_lstm_builds_and_raises_at_the_similarity():
    jmodel, params, model, _ = pair("seqLSTM")
    assert "frame_position_embeddings.weight" in model.state_dict()
    b = make_batch(5)
    ref_vis = _jax(jmodel, params, lambda m, v, vm: m.get_visual_output(
        v, m.video_mask_after_cluster(vm))[0], b["video"], b["video_mask"])
    vm = model.video_mask_after_cluster(t(b["video_mask"]))
    with torch.no_grad():
        vis = model.get_visual_output(t(b["video"]), vm)
    np.testing.assert_allclose(vis.numpy(), ref_vis, **FP32)
    with pytest.raises((NotImplementedError, AssertionError)):
        _jax(jmodel, params,
             lambda m, s, v, vm: m.get_similarity_logits(s, v, None, vm),
             np.ones((3, 1, 16), np.float32), ref_vis, np.asarray(vm))
    with pytest.raises(NotImplementedError, match="seqLSTM"):
        model.get_similarity_logits(torch.ones(3, 1, 16), vis, None, vm)
    with pytest.raises(NotImplementedError, match="seqLSTM"):
        model(**loop.batch_to_device(b, torch.device("cpu")), training=True)


def test_builder_turns_tf32_off(monkeypatch):
    """Building a model sets the JAX package's fp32 numerics: no TF32 in
    cuBLAS matmuls nor in cuDNN convolutions (PyTorch's default for the
    latter is on)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    run = port_config.make_run_config(**config_kw("seqTransf"))
    CLIP4Clip(run.model, device="cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_seq_transf_logits_match_jax_on_cached_features():
    """`get_similarity_logits` on cached features whose mask is still the
    pre-cluster one: both packages subsample it first."""
    jmodel, params, model, _ = pair("seqTransf")
    g = np.random.default_rng(6)
    seq = g.standard_normal((5, 1, 16)).astype(np.float32)
    vis = g.standard_normal((3, 2, 16)).astype(np.float32)
    vmask = np.array([[1, 1, 1, 1], [1, 1, 0, 0], [1, 1, 1, 0]], np.int32)
    ref = _jax(jmodel, params,
               lambda m, s, v, vm: m.get_similarity_logits(s, v, None, vm),
               seq, vis, vmask)
    with torch.no_grad():
        out = model.get_similarity_logits(t(seq), t(vis), None, t(vmask))
    assert ref.shape == (5, 3)
    np.testing.assert_allclose(out.numpy(), ref, **FP32)
