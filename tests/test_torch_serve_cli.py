# coding=utf-8
"""The port's serve CLI (`centerclip_tpu_torch/serve/cli.py`) on the CPU:
the JAX package's CLI tests (tests/test_serve_cli.py) on the same tiny
MSR-VTT fixture through the port's data registry, with `device="cpu"`, and
the port's `build` + `query` against the JAX package's from one exported
checkpoint."""
import dataclasses
import json
import os
import threading
import urllib.request
from contextlib import contextmanager

import jax
import numpy as np
import pytest
import torch

from tests.test_main_e2e import msrvtt_root  # noqa: F401 (fixture)
from centerclip_tpu import cli as jax_cli
from centerclip_tpu import config as jax_config
from centerclip_tpu.models.clip4clip import CLIP4Clip as JaxCLIP4Clip
from centerclip_tpu.serve import cli as jax_serve_cli
from centerclip_tpu.train import state as jax_state
from centerclip_tpu_torch import cli as port_cli
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.serve import cli as serve_cli
from centerclip_tpu_torch.serve.http import RetrievalServer
from centerclip_tpu_torch.serve.index import VideoIndex, load_index
from centerclip_tpu_torch.serve.ivf import IVFVideoIndex

TINY = jax_config.CLIP_ARCHS["tiny-e2e"]


@pytest.fixture(autouse=True)
def tiny_arch(monkeypatch):
    monkeypatch.setitem(port_config.CLIP_ARCHS, "tiny-e2e", TINY)


@contextmanager
def _res32(cli_mod=port_cli):
    """Force the dataset image resolution to the tiny arch's input size
    (tests/test_serve_cli.py `_res32`)."""
    orig = cli_mod.args_to_run_config

    def patched(args):
        cfg = orig(args)
        return dataclasses.replace(
            cfg, data=dataclasses.replace(cfg.data, image_resolution=32))

    cli_mod.args_to_run_config = patched
    try:
        yield
    finally:
        cli_mod.args_to_run_config = orig


def _flags(root, out):
    return [
        "--datatype", "msrvtt",
        "--train_csv", str(root / "train.csv"),
        "--val_csv", str(root / "test.csv"),
        "--data_path", str(root / "MSRVTT_data.json"),
        "--features_path", str(root / "videos"),
        "--video_suffix", ".npy",
        "--output_dir", str(out),
        "--pretrained_clip_name", "tiny-e2e",
        "--pretrained_dir", str(root / "no_weights"),
        "--max_words", "12", "--max_frames", "4",
        "--batch_size_val", "3",  # 8 videos -> ragged tail batch of 2
        "--loose_type", "--sim_header", "meanP",
        "--cluster_inter", "1", "--cluster_algo", "kmediods++",
        "--cluster_num_blocks", "3", "3",
        "--target_frames_blocks", "4", "2",
        "--precision", "fp32",
        "--num_thread_reader", "0",
    ]


def _run(argv):
    with _res32():
        return serve_cli.main(argv, device="cpu")


def test_serve_cli_build_then_query(msrvtt_root, tmp_path, capsys):  # noqa: F811
    idx_path = str(tmp_path / "gallery.npz")
    flags = _flags(msrvtt_root, tmp_path / "out")
    index = _run(["build", "--index_path", idx_path, "--quantize", "int8"]
                 + flags)
    assert os.path.exists(idx_path)
    assert len(index) == 8 and index.quantize == "int8"
    assert index.video_ids == [f"video{i}" for i in range(8)]
    built = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert built["videos"] == 8 and built["quantize"] == "int8"

    results = _run(["query", "--index_path", idx_path, "--topk", "3",
                    "--query", "a person cooking in a kitchen",
                    "--query", "someone driving a car"] + flags)
    out_lines = [json.loads(line) for line in
                 capsys.readouterr().out.strip().splitlines()]
    assert len(results) == 2 and len(out_lines) == 2
    for line, ranked in zip(out_lines, results):
        assert len(ranked) == 3
        ids = [r["video_id"] for r in ranked]
        assert set(ids) <= {f"video{i}" for i in range(8)}
        scores = [r["score"] for r in ranked]
        assert scores == sorted(scores, reverse=True)
        assert [r["video_id"] for r in line["results"]] == ids

    # the saved index round-trips standalone
    assert VideoIndex.load(idx_path, device="cpu").video_ids == \
        index.video_ids


def test_serve_cli_build_query_ivf(msrvtt_root, tmp_path, capsys):  # noqa: F811
    """--index_type ivf end to end: build a cluster-pruned index from the
    dataset, reload it through the meta dispatcher, answer queries."""
    idx_path = str(tmp_path / "gallery_ivf.npz")
    flags = _flags(msrvtt_root, tmp_path / "out")
    index = _run(["build", "--index_path", idx_path, "--index_type", "ivf",
                  "--n_clusters", "4", "--nprobe", "4", "--quantize", "int8"]
                 + flags)
    assert isinstance(index, IVFVideoIndex)
    assert index.n_clusters == 4 and len(index) == 8
    built = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert built["index_type"] == "ivf"

    results = _run(["query", "--index_path", idx_path, "--topk", "3",
                    "--query", "a person cooking in a kitchen"] + flags)
    assert len(results) == 1 and len(results[0]) == 3
    assert all(r["video_id"].startswith("video") for r in results[0])

    # the meta dispatcher picks the right class; the flat loader refuses
    assert isinstance(load_index(idx_path, device="cpu"), IVFVideoIndex)
    with pytest.raises(ValueError, match="load_index"):
        VideoIndex.load(idx_path, device="cpu")


def test_serve_cli_data_parallel_equals_one_device(msrvtt_root, tmp_path,  # noqa: F811
                                                  capsys):
    """`--data_parallel 2` on two CPU "cards": the gallery batches (3, 3,
    2 clips, padded to 4) split 2 + 2 over the replicas and the flat
    index's rows 4 + 4; the build's codes and ids, and a query's ids and
    scores (within 1e-6) equal the one-device run's, across both
    layouts."""
    flags = _flags(msrvtt_root, tmp_path / "out")
    paths = {n: str(tmp_path / f"gallery_{n}.npz") for n in (1, 2)}
    built = {n: _run(["build", "--index_path", paths[n],
                      "--data_parallel", str(n)] + flags) for n in (1, 2)}
    assert [d.type for d in built[2].devices] == ["cpu", "cpu"]
    assert len(built[2]._parts) == 2 and built[2].n_padded == 8
    assert built[2].video_ids == built[1].video_ids
    np.testing.assert_allclose(built[2]._codes.numpy(),
                               built[1]._codes.numpy(), rtol=0, atol=1e-6)
    queries = ["--query", "a person cooking in a kitchen",
               "--query", "someone driving a car", "--query", "video3"]
    results = {}
    for layout in ((1, 1), (2, 2), (1, 2), (2, 1)):
        results[layout] = _run(
            ["query", "--index_path", paths[layout[0]], "--topk", "5",
             "--data_parallel", str(layout[1])] + queries + flags)
    capsys.readouterr()
    ref = results[(1, 1)]
    for layout, got in results.items():
        for a, b in zip(got, ref):
            assert [r["video_id"] for r in a] == [r["video_id"] for r in b]
            np.testing.assert_allclose([r["score"] for r in a],
                                       [r["score"] for r in b], rtol=0,
                                       atol=1e-6, err_msg=str(layout))


def test_serve_cli_http_daemon(msrvtt_root, tmp_path, capsys, monkeypatch):  # noqa: F811
    """`serve`: load the index, bind, warm up, answer a live request."""
    idx_path = str(tmp_path / "gallery.npz")
    flags = _flags(msrvtt_root, tmp_path / "out")
    _run(["build", "--index_path", idx_path, "--quantize", "int8"] + flags)
    capsys.readouterr()

    # serve_forever blocks; answer one request inside it instead
    def fake_serve_forever(self):
        url = "http://%s:%d/search" % self.address
        req = urllib.request.Request(
            url, data=json.dumps({"queries": ["a person cooking"],
                                  "k": 2}).encode(),
            headers={"Content-Type": "application/json"})
        self._httpd.timeout = 1
        out = {}

        def ask():
            with urllib.request.urlopen(req, timeout=60) as resp:
                out["body"] = json.loads(resp.read())
        t = threading.Thread(target=ask)
        t.start()
        while t.is_alive():
            self._httpd.handle_request()
        t.join()
        fake_serve_forever.body = out["body"]

    monkeypatch.setattr(RetrievalServer, "serve_forever", fake_serve_forever)
    server = _run(["serve", "--index_path", idx_path, "--port", "0",
                   "--topk", "3"] + flags)
    assert isinstance(server, RetrievalServer)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["videos"] == 8 and line["listening"].startswith("http://")
    ranked = fake_serve_forever.body["results"][0]
    assert len(ranked) == 2
    assert all(r["video_id"].startswith("video") for r in ranked)
    assert ranked == server.engine.search(["a person cooking"], k=2)[0]
    server._httpd.server_close()


def test_gallery_batches_multi_sentence_dedupe():
    """Multi-sentence filtering + re-batching: unique videos at cut-offs,
    full-width batches, ragged tail; the same rows as the JAX package's."""
    cuts = [2, 5, 7]          # 3 videos with 2/3/2 captions
    rows = 7
    video = np.arange(rows, dtype=np.float32).reshape(rows, 1, 1, 1, 1, 1)
    batches = [  # loader batch size 3 -> batches of 3, 3, 1 rows
        {"video": video[s:s + 3],
         "video_mask": np.ones((min(3, rows - s), 2), np.int32)}
        for s in range(0, rows, 3)]
    out = list(serve_cli.gallery_batches(batches, True, cuts, batch_size=2))
    assert all(torch.is_tensor(b["video"]) for b in out)
    got = torch.cat([b["video"] for b in out]).numpy().ravel()
    # rows 1, 4, 6 are the last caption of each video
    np.testing.assert_array_equal(got, [1.0, 4.0, 6.0])
    assert [b["video_mask"].shape[0] for b in out] == [2, 1]
    ref = list(jax_serve_cli.gallery_batches(batches, True, cuts,
                                             batch_size=2))
    for a, b in zip(out, ref):
        for key in ("video", "video_mask"):
            np.testing.assert_array_equal(a[key].numpy(), b[key])
    # without multi-sentence: full-width re-batching of every row
    plain = list(serve_cli.gallery_batches(batches, False, cuts,
                                           batch_size=4))
    assert [b["video"].shape[0] for b in plain] == [4, 3]

    class DS:
        sentences_dict = {i: (f"vid{v}", "cap") for i, v in
                          enumerate([0, 0, 1, 1, 1, 2, 2])}

        def __len__(self):
            return 7

    assert serve_cli.gallery_video_ids(DS(), True, cuts) == \
        ["vid0", "vid1", "vid2"]
    assert serve_cli.gallery_video_ids(DS(), False, cuts)[:3] == \
        ["vid0", "vid0", "vid1"]


@pytest.mark.parametrize("quantize", ["float32", "int8"])
def test_port_build_and_query_equal_jax_from_one_checkpoint(
        msrvtt_root, tmp_path, capsys, quantize):  # noqa: F811
    """One init checkpoint, exported by the JAX side: both packages' CLIs
    build the gallery (same ids) and answer the same queries with the same
    ranked ids and scores (fp32 towers; the score matmul's bf16 operands
    are the same, its fp32 sums are taken in another order)."""
    flags = _flags(msrvtt_root, tmp_path / "out")
    with _res32(jax_cli):
        jcfg = jax_cli.parse_args(flags)
    params = JaxCLIP4Clip(jcfg.model).init(
        jax.random.PRNGKey(3), input_ids=np.zeros((2, 12), np.int32),
        video=np.zeros((2, 1, 4, 3, 32, 32), np.float32),
        video_mask=np.ones((2, 4), np.int32), training=True)["params"]
    init = str(tmp_path / "init.pth.tar")
    jax_state.export_torch_checkpoint(params, jcfg.model, init)
    flags += ["--init_model", init]
    queries = ["a person cooking in a kitchen", "someone driving a car",
               "video3 doing stuff 1"]
    qflags = ["--topk", "8"] + sum((["--query", q] for q in queries), [])

    jpath, ppath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    with _res32(jax_cli):
        jindex = jax_serve_cli.main(["build", "--index_path", jpath,
                                     "--quantize", quantize] + flags)
        jres = jax_serve_cli.main(["query", "--index_path", jpath]
                                  + qflags + flags)
    pindex = _run(["build", "--index_path", ppath, "--quantize", quantize]
                  + flags)
    pres = _run(["query", "--index_path", ppath] + qflags + flags)
    capsys.readouterr()
    assert pindex.video_ids == jindex.video_ids == \
        [f"video{i}" for i in range(8)]
    codes = pindex._codes[:8].float().numpy()
    jcodes = np.asarray(jindex._codes_host[:8], np.float32)
    if quantize == "int8":        # codes may move by one where a rounding
        assert np.abs(codes - jcodes).max() <= 1     # tie fell either way
    else:
        np.testing.assert_allclose(codes, jcodes, rtol=1e-4, atol=1e-5)
    for p, j in zip(pres, jres):
        assert [r["video_id"] for r in p] == [r["video_id"] for r in j]
        np.testing.assert_allclose([r["score"] for r in p],
                                   [r["score"] for r in j], rtol=1e-3,
                                   atol=1e-3)
