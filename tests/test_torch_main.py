# coding=utf-8
"""The port's CLI, weight initialisation and `main` against the JAX
package's, on the CPU.

The slice as a whole: both mains train the `tiny-e2e` model of
tests/test_main_e2e.py (2 + 2 blocks of width 32, 4 frames -> 2 segments,
K = 3, fp32) for one epoch on the same synthetic MSR-VTT from one
`--init_model` checkpoint the JAX side exports, evaluate, and write their
checkpoints.  Losses are held at rtol 1e-5 and the exported weights at
2e-2 x lr (tests/test_torch_train.py:60-66, 322-324).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import torch
from torch import nn

from centerclip_tpu import cli as jax_cli
from centerclip_tpu import config as jax_config
from centerclip_tpu.models import weights as jax_weights
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.train import state as jax_state
from centerclip_tpu_torch import cli
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.models import weights
from centerclip_tpu_torch.models.clip4clip import CLIP4Clip
from centerclip_tpu_torch.models.weights import clip4clip_entries
from centerclip_tpu_torch.train import evaluate, state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(embed_dim=16, image_resolution=32, vision_layers=2,
            vision_width=32, vision_patch_size=16, vision_heads=2,
            context_length=12, vocab_size=49408, transformer_width=32,
            transformer_heads=2, transformer_layers=2)
LR = 1e-3
STEP_ATOL = 2e-2 * LR

# scripts/msrvtt.sh: `common` and experiment 62
EXP62 = [
    "--do_train", "1", "--do_eval", "1", "--datatype", "msrvtt",
    "--train_csv", "d/train.csv", "--val_csv", "d/test.csv",
    "--data_path", "d/MSRVTT_data.json", "--features_path", "d/videos",
    "--output_dir", "out/eclip_msrvtt_62",
    "--max_words", "32", "--max_frames", "12", "--feature_framerate", "3",
    "--batch_size", "128", "--batch_size_val", "128", "--epochs", "5",
    "--optim", "AdamW", "--lr", "2e-3", "--coef_lr", "1e-3", "--wd", "0.2",
    "--warmup_proportion", "0.1", "--loose_type", "--sim_header", "meanP",
    "--slice_framepos", "2", "--expand_msrvtt_sentences", "--precision",
    "amp", "--pretrained_clip_name", "ViT-B/32", "--num_thread_reader", "8",
    "--cluster_inter", "1", "--cluster_algo", "kmediods++",
    "--cluster_num_blocks", *["49"] * 12,
    "--target_frames_blocks", *["12"] * 6, *["6"] * 6]


@pytest.fixture(autouse=True)
def tiny_arch(monkeypatch):
    """The tiny-e2e arch in both packages' CLIP_ARCHS, for one test."""
    monkeypatch.setitem(jax_config.CLIP_ARCHS, "tiny-e2e", TINY)
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-e2e", TINY)


def _actions(parser):
    return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                     a.nargs, a.required, a.const)
            for a in parser._actions}


# ------------------------------------------------------------------- CLI
def test_cli_has_every_flag_and_default_of_the_jax_cli():
    assert _actions(cli.get_parser()) == _actions(jax_cli.get_parser())


@pytest.mark.parametrize("extra", [[], ["--precision", "fp32", "--seed", "3",
                                        "--freeze_layer_num", "-1"]])
def test_cli_experiment_62_config_equals_jax(extra, tmp_path):
    a, b = cli.parse_args(EXP62 + extra), jax_cli.parse_args(EXP62 + extra)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.model == port_config.preset(
        "msrvtt_vitb32_k6", compute_dtype=a.model.compute_dtype).model
    assert (a.batch_size, a.optim.lr, a.data.num_thread_reader) == \
        (128, 2e-3, 8)
    port_config.save_hparams(str(tmp_path / "p"), a)
    jax_config.save_hparams(str(tmp_path / "j"), b)
    with open(tmp_path / "p" / "hparams_train.json") as f, \
            open(tmp_path / "j" / "hparams_train.json") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("flag", [["--data_parallel", "2"],
                                  ["--tensor_parallel", "2"],
                                  ["--fsdp", "1"],
                                  ["--pipeline_parallel", "2"],
                                  ["--sequence_parallel", "1"]])
def test_cli_refuses_the_parallel_strategies(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md section 2"):
        cli.parse_args(EXP62 + flag)
    jax_cli.parse_args(EXP62 + flag + (["--tensor_parallel", "2"]
                                       if "--sequence_parallel" in flag
                                       else []))


@pytest.mark.parametrize("extra", [["--sim_header", "seqTransf"],
                                   ["--sim_header", "seqLSTM"],
                                   ["--linear_patch", "3d"],
                                   ["--pretrained_clip_name", "RN50"]])
def test_unported_algorithms_parse_and_the_builder_refuses(extra):
    cfg = cli.parse_args(EXP62 + extra)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_cli.parse_args(EXP62 + extra))
    with pytest.raises(NotImplementedError):
        CLIP4Clip(cfg.model, device="cpu")


# ------------------------------------------------------- pretrain tricks
def _tiny_kw(**over):
    kw = dict(clip_name="tiny-e2e", max_frames=4, max_words=12,
              compute_dtype="float32", inter=True, algo="kmediods++",
              cluster_num_blocks=(3, 3), target_frames_blocks=(4, 2))
    kw.update(over)
    return kw


def _raw_clip_state_dict(seed=0, dtype=np.float16):
    """OpenAI's raw CLIP key schema (no `clip.` prefix) for the tiny arch,
    the values rounded to fp16 as in OpenAI's archives."""
    cfg = port_config.make_run_config(**_tiny_kw()).model
    g = np.random.default_rng(seed)
    sd = {k[len("clip."):]: torch.from_numpy(
        g.standard_normal(tuple(v.shape)).astype(dtype))
        for k, v in CLIP4Clip(cfg, device="cpu").state_dict().items()
        if k.startswith("clip.") and "tokencluster_inter" not in k}
    sd["logit_scale"] = torch.tensor(4.6, dtype=torch.float16)
    return sd


@pytest.mark.parametrize("over", [
    {}, {"sim_header": "seqLSTM"}, {"sim_header": "seqTransf"},
    {"sim_header": "tightTransf", "cross_num_hidden_layers": 1},
    {"linear_patch": "3d"}, {"cluster_embedding": True},
    {"cluster_embedding": True, "cluster_embed_from_clip": False},
    {"cluster_embedding": True, "inter": False, "cluster_num_blocks": (),
     "target_frames_blocks": ()}])
@pytest.mark.parametrize("preseeded", [False, True])
def test_apply_pretrain_tricks_equals_jax(over, preseeded):
    kw = _tiny_kw(**over)
    jcfg = jax_config.make_run_config(**kw).model
    cfg = port_config.make_run_config(**kw).model
    sd = {"clip." + k: v.float() for k, v in _raw_clip_state_dict().items()}
    if preseeded:          # keys the state dict has are kept, not reseeded
        sd["frame_position_embeddings.weight"] = torch.zeros(12, 32)
        sd["cross.transformer.resblocks.0.ln_1.weight"] = torch.ones(32)
        sd["clip.visual.conv2.weight"] = torch.ones(32, 3, 3, 16, 16)
        sd["clip.visual.transformer.resblocks.1.tokencluster_inter."
           "cluster_embed"] = torch.full((3, 32), 2.0)
    ref = jax_weights.apply_pretrain_tricks(
        {k: v.numpy() for k, v in sd.items()}, jcfg)
    got = weights.apply_pretrain_tricks(sd, cfg)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    new = set(got) - set(sd)
    assert all(got[k].data_ptr() != v.data_ptr() for k in new
               for v in sd.values())


class _Node(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _write_torchscript_archive(sd, path, extra=()):
    """A TorchScript archive whose state dict is `sd` (OpenAI ships its CLIP
    weights as one), with the three int entries OpenAI's archives carry."""
    root = _Node()
    for key, value in list(sd.items()) + list(extra):
        *mods, leaf = key.split(".")
        node = root
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, _Node())
            node = getattr(node, m)
        if value.is_floating_point():
            node.register_parameter(leaf, nn.Parameter(value,
                                                       requires_grad=False))
        else:
            node.register_buffer(leaf, value)
    torch.jit.script(root).save(str(path))


@pytest.mark.parametrize("temperature_new", [1.0, 2.5])
def test_init_from_pretrained_clip_equals_jax_loader(tmp_path,
                                                     temperature_new):
    kw = _tiny_kw(cluster_embedding=True, adaptive_cls=True)
    jrun, run = (jax_config.make_run_config(**kw),
                 port_config.make_run_config(**kw))
    path = tmp_path / "ViT-tiny.pt"
    _write_torchscript_archive(
        _raw_clip_state_dict(), path,
        extra=[("input_resolution", torch.tensor(32)),
               ("context_length", torch.tensor(12)),
               ("vocab_size", torch.tensor(49408)),
               ("visual.extra_weight", torch.ones(2, dtype=torch.float16))])
    jmodel = JaxCLIP4Clip(jrun.model)
    init = jmodel.init(jax.random.PRNGKey(0),
                       input_ids=np.zeros((2, 12), np.int32),
                       video=np.zeros((2, 1, 4, 3, 32, 32), np.float32),
                       video_mask=np.ones((2, 4), np.int32),
                       training=True)["params"]
    jparams, jreport = jax_state.init_from_pretrained_clip(
        str(path), jrun.model, jax.tree_util.tree_map(np.asarray, init),
        temperature_new=temperature_new)
    model = CLIP4Clip(run.model, device="cpu", seed=3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, report = state.init_from_pretrained_clip(
        str(path), run.model, model=model, temperature_new=temperature_new)
    assert report == jreport
    assert report["unexpected"] == ["clip.visual.extra_weight"]
    assert [k.split(".")[-1] for k in report["missing"]] == \
        ["cls_multiplier"]
    sd = model.state_dict()
    for jpath, key, tf in clip4clip_entries(run.model):
        if key in report["missing"]:        # left at the model's own init
            assert torch.equal(sd[key], before[key]), key
            continue
        ref = np.asarray(jax_weights._get_path(jparams, jpath))
        np.testing.assert_array_equal(sd[key].numpy(),
                                      ref.T if tf == "T" else ref,
                                      err_msg=key)
    expected = temperature_new if temperature_new > 1 else np.float32(
        np.float16(4.6))
    assert float(model.clip.logit_scale.detach()) == pytest.approx(expected)
    assert torch.equal(
        sd["clip.visual.transformer.resblocks.1.tokencluster_inter."
           "cluster_embed"], sd["clip.visual.positional_embedding"][1:4])


def test_import_torch_checkpoint_reports_like_jax(tmp_path):
    kw = _tiny_kw()
    jrun, run = (jax_config.make_run_config(**kw),
                 port_config.make_run_config(**kw))
    model = CLIP4Clip(run.model, device="cpu", seed=4)
    sd = {k: v for k, v in model.state_dict().items()
          if "resblocks.1.mlp" not in k}
    sd["module_less.extra"] = torch.zeros(3)
    torch.save({"epoch": 0, "state_dict": sd}, tmp_path / "c.pth.tar")
    other = CLIP4Clip(run.model, device="cpu", seed=5)
    before = {k: v.clone() for k, v in other.state_dict().items()}
    got, report = state.import_torch_checkpoint(
        str(tmp_path / "c.pth.tar"), run.model, model=other)
    _, jreport = jax_state.import_torch_checkpoint(
        str(tmp_path / "c.pth.tar"), jrun.model)
    assert report == jreport and len(report["missing"]) == 8
    assert report["unexpected"] == ["module_less.extra"]
    for k, v in other.state_dict().items():
        assert torch.equal(v, (model.state_dict() if k in got else
                               before)[k]), k


# ---------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    """tests/test_main_e2e.py's fixture: 8 videos of 10 frames of 40 x 48,
    8 eval rows, 2 captions per video."""
    root = tmp_path_factory.mktemp("msrvtt_main")
    rng = np.random.default_rng(0)
    vids = [f"video{i}" for i in range(8)]
    (root / "videos").mkdir()
    for v in vids:
        np.save(root / "videos" / f"{v}.npy",
                rng.integers(0, 255, size=(10, 40, 48, 3)).astype(np.uint8))
    pd.DataFrame({"video_id": vids,
                  "sentence": [f"a clip about thing {i}" for i in
                               range(len(vids))]}).to_csv(
        root / "test.csv", index=False)
    pd.DataFrame({"video_id": vids}).to_csv(root / "train.csv", index=False)
    corpus = {"sentences": [{"video_id": v, "caption": f"{v} doing stuff {j}"}
                            for v in vids for j in range(2)],
              "videos": [{"video_id": v, "url": f"u?v=p{v}"} for v in vids]}
    with open(root / "MSRVTT_data.json", "w") as f:
        json.dump(corpus, f)
    return root


def _argv(root, out, extra=()):
    return [
        "--do_train", "1", "--do_eval", "1", "--datatype", "msrvtt",
        "--train_csv", str(root / "train.csv"),
        "--val_csv", str(root / "test.csv"),
        "--data_path", str(root / "MSRVTT_data.json"),
        "--features_path", str(root / "videos"), "--video_suffix", ".npy",
        "--output_dir", str(out), "--pretrained_clip_name", "tiny-e2e",
        "--pretrained_dir", str(root / "no_weights"),
        "--max_words", "12", "--max_frames", "4",
        "--batch_size", "8", "--batch_size_val", "4", "--epochs", "1",
        "--optim", "AdamW", "--lr", str(LR), "--loose_type",
        "--sim_header", "meanP", "--expand_msrvtt_sentences",
        "--cluster_inter", "1", "--cluster_algo", "kmediods++",
        "--cluster_num_blocks", "3", "3", "--target_frames_blocks", "4", "2",
        "--precision", "fp32", "--num_thread_reader", "2", "--n_display", "1",
    ] + list(extra)


def _with_resolution(cli_mod, fn, resolution=32):
    """Run fn() with the data config's image resolution forced to the tiny
    arch's input size (tests/test_main_e2e.py:94-111)."""
    orig = cli_mod.args_to_run_config

    def patched(args):
        cfg = orig(args)
        return dataclasses.replace(cfg, data=dataclasses.replace(
            cfg.data, image_resolution=resolution))
    cli_mod.args_to_run_config = patched
    try:
        return fn()
    finally:
        cli_mod.args_to_run_config = orig


def _losses(out):
    with open(out / "tensorboard" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return [r["step"] for r in recs], [r["train/sim_loss"] for r in recs]


def _tree(out):
    """Top-level names, and the tensorboard directory's kinds of files."""
    tb = sorted("events" if n.startswith("events.out.tfevents") else n
                for n in os.listdir(out / "tensorboard"))
    return sorted(os.listdir(out)), tb


def test_main_matches_jax_main_from_one_init_checkpoint(msrvtt_root,
                                                        tmp_path,
                                                        monkeypatch):
    import main as jax_main
    from centerclip_tpu_torch import main as port_main
    # one init checkpoint, exported by the JAX side
    jcfg = _with_resolution(jax_cli, lambda: jax_cli.parse_args(
        _argv(msrvtt_root, tmp_path / "unused")))
    params = JaxCLIP4Clip(jcfg.model).init(
        jax.random.PRNGKey(7), input_ids=np.zeros((2, 12), np.int32),
        video=np.zeros((2, 1, 4, 3, 32, 32), np.float32),
        video_mask=np.ones((2, 4), np.int32), training=True)["params"]
    init = str(tmp_path / "init.pth.tar")
    jax_state.export_torch_checkpoint(params, jcfg.model, init)
    extra = ["--init_model", init]

    jout, pout = tmp_path / "jax", tmp_path / "port"
    jbest = _with_resolution(jax_cli, lambda: jax_main.main(
        _argv(msrvtt_root, jout, extra)))
    evals = []
    orig_evaluate = evaluate.Evaluator.evaluate

    def recording(self, *a, **k):
        evals.append(orig_evaluate(self, *a, **k))
        return evals[-1]
    monkeypatch.setattr(evaluate.Evaluator, "evaluate", recording)
    pbest = _with_resolution(cli, lambda: port_main.main(
        _argv(msrvtt_root, pout, extra + ["--profile_dir",
                                          str(tmp_path / "prof"),
                                          "--profile_steps", "1"]),
        device="cpu"))

    jsteps, jl = _losses(jout)
    psteps, pl = _losses(pout)
    assert jsteps == psteps == [1, 2]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jsd = torch.load(jout / "ckpt.pth.tar", weights_only=False)
    psd = torch.load(pout / "ckpt.pth.tar", weights_only=False)
    assert (psd["epoch"], psd["global_step"], psd["arch"]) == \
        (jsd["epoch"], jsd["global_step"], jsd["arch"]) == (0, 2, "CLIP4Clip")
    assert sorted(psd["state_dict"]) == sorted(jsd["state_dict"])
    first = torch.load(init, weights_only=False)["state_dict"]
    moved = 0
    for k, v in jsd["state_dict"].items():
        np.testing.assert_allclose(psd["state_dict"][k].numpy(), v.numpy(),
                                   rtol=0, atol=STEP_ATOL, err_msg=k)
        moved += not torch.equal(v, first[k])
    assert moved > 0
    assert pbest == jbest
    assert _tree(pout) == _tree(jout)
    with open(pout / "hparams_train.json") as f, \
            open(jout / "hparams_train.json") as g:
        ph, jh = json.load(f), json.load(g)
    for h in (ph, jh):              # the flags the two runs differ in
        for k in ("output_dir", "profile_dir", "profile_steps"):
            h.pop(k)
    assert ph == jh
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]

    # eval-only reload of the port's checkpoint: the same metrics
    argv = _argv(msrvtt_root, tmp_path / "port_eval",
                 ["--init_model", str(pout / "ckpt.pth.tar")])
    argv[1] = "0"
    res = _with_resolution(cli, lambda: port_main.main(argv, device="cpu"))
    assert len(evals) == 2 and res is evals[1]
    for d in ("t2v", "v2t"):
        assert res[d] == evals[0][d]
    np.testing.assert_array_equal(res["sim_matrix"], evals[0]["sim_matrix"])
    assert res["R1"] == pbest


def test_main_without_a_card_exits_with_resolve_devices_error(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "out"
    argv = list(EXP62)
    argv[argv.index("--output_dir") + 1] = str(out)
    res = subprocess.run(
        [sys.executable, "-m", "centerclip_tpu_torch.main"] + argv, cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert not out.exists()


def test_main_fails_fast_on_a_missing_data_path(msrvtt_root, tmp_path):
    from centerclip_tpu_torch import main as port_main
    argv = _argv(msrvtt_root, tmp_path / "o")
    argv[argv.index("--features_path") + 1] = str(tmp_path / "missing")
    with pytest.raises(SystemExit, match="--features_path does not exist"):
        port_main.main(argv, device="cpu")


def test_main_resumes_from_its_checkpoint(msrvtt_root, tmp_path):
    """`--resume <out>/ckpt_0` of a 2-epoch run restores the parameters,
    the optimizer and the step count and starts at epoch 1: the resumed
    run takes the uninterrupted run's epoch-1 steps, with the same losses,
    and ends on the same weights; the best R@1 carries over."""
    from centerclip_tpu_torch import main as port_main
    out = tmp_path / "first"
    two = ["--epochs", "2"]
    best = _with_resolution(cli, lambda: port_main.main(
        _argv(msrvtt_root, out, two), device="cpu"))
    steps, losses = _losses(out)
    assert steps == [1, 2, 3, 4]
    argv = _argv(msrvtt_root, tmp_path / "resumed",
                 two + ["--resume", str(out / "ckpt_0")])
    best2 = _with_resolution(cli, lambda: port_main.main(argv,
                                                         device="cpu"))
    steps2, losses2 = _losses(tmp_path / "resumed")
    assert steps2 == steps[2:] and losses2 == losses[2:]
    ckpt = torch.load(tmp_path / "resumed" / "ckpt.pth.tar",
                      weights_only=False)
    ref = torch.load(out / "ckpt.pth.tar", weights_only=False)
    assert (ckpt["epoch"], ckpt["global_step"]) == \
        (ref["epoch"], ref["global_step"]) == (1, 4)
    assert sorted(ckpt["state_dict"]) == sorted(ref["state_dict"])
    for k, v in ref["state_dict"].items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    assert best2 == best


@pytest.mark.parametrize("flags", [
    ["--cluster_algo", "spectral", "--spectral_graph", "KNN",
     "--spectral_knn_k", "5"],
    ["--cluster_algo", "sparse_sampling"],
    ["--cluster_inter", "0", "--deep_cluster", "1"]])
def test_main_trains_and_evaluates_the_other_cluster_algorithms(
        msrvtt_root, tmp_path, flags):
    """`main` with another algorithm's flags (the later flag wins): an
    epoch of training with its losses logged (a positive cluster loss for
    deep_cluster only), the evaluation, the checkpoint."""
    from centerclip_tpu_torch import main as port_main
    out = tmp_path / "out"
    best = _with_resolution(cli, lambda: port_main.main(
        _argv(msrvtt_root, out) + flags, device="cpu"))
    assert np.isfinite(best)
    with open(out / "tensorboard" / "scalars.jsonl") as f:
        recs = [json.loads(line) for line in f]
    closs = [r["train/cluster_loss"] for r in recs if
             "train/cluster_loss" in r]
    assert closs and all(np.isfinite(closs))
    assert all((c > 0) == ("--deep_cluster" in flags) for c in closs)
    sd = torch.load(out / "ckpt.pth.tar", weights_only=False)["state_dict"]
    assert any("deepcluster" in k for k in sd) == ("--deep_cluster" in flags)
