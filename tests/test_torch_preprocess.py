# coding=utf-8
"""The port's preprocess tools, `data/cv2_decode.py`, `utils/file_cache.py`
and `utils/misc.py` against the JAX package's, on the CPU.

Each tool runs on the same seeded inputs as the JAX tool (the cases of
tests/test_preprocess.py and tests/test_file_cache.py), and their outputs
must be equal: a `.fstore` byte for byte, JSON files, PNGs, and the medoid
ids that `visualize_clusters` computes from raw patch pixels (plain fp32
k-medoids on both sides).  Commands that would reach the network or an
absent binary are checked through a patched `subprocess.run`; HTTP goes to
a server on 127.0.0.1.  Nothing reaches the network.
"""
import argparse
import filecmp
import importlib
import io
import json
import os
import sys
import tarfile
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import pytest
import torch

from centerclip_tpu.data import cv2_decode as jax_cv2
from centerclip_tpu.models import cross as jax_cross
from centerclip_tpu.preprocess import build_framestore as jax_bf
from centerclip_tpu.preprocess import check_video as jax_cv
from centerclip_tpu.preprocess import compress_video as jax_compress
from centerclip_tpu.preprocess import download_lsmdc as jax_dl
from centerclip_tpu.preprocess import generate_video_path as jax_gvp
from centerclip_tpu.preprocess import visualize_clusters as jax_vc
from centerclip_tpu.utils import file_cache as jax_fc
from centerclip_tpu.utils import misc as jax_misc
from centerclip_tpu_torch.data import cv2_decode
from centerclip_tpu_torch.data.framestore import FrameStore
from centerclip_tpu_torch.models import cross
from centerclip_tpu_torch.preprocess import (build_framestore, check_video,
                                             compress_video, download_lsmdc,
                                             folder2lmdb, generate_video_path,
                                             visualize_clusters)
from centerclip_tpu_torch.utils import file_cache, misc


def _run_jax_main(module, monkeypatch, argv):
    """The JAX tools read sys.argv (visualize_clusters takes argv)."""
    monkeypatch.setattr(sys, "argv", ["x"] + argv)
    return module.main()


def _clip_folder(root, n=3, shape=(5, 16, 20, 3)):
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        np.save(root / f"clip{i}.npy",
                rng.integers(0, 255, size=shape).astype(np.uint8))
    return root


# ------------------------------------------------------ build_framestore
@pytest.mark.parametrize("n", [3, 12])
def test_build_framestore_equals_the_jax_tool_byte_for_byte(tmp_path,
                                                             monkeypatch, n):
    """12 clips: names that sort otherwise as text than as numbers."""
    src = _clip_folder(tmp_path / "vids", n=n)
    ours, theirs = str(tmp_path / "port.fstore"), str(tmp_path / "jax.fstore")
    assert build_framestore.main(["--input_root", str(src), "--output",
                                  ours]) == n
    _run_jax_main(jax_bf, monkeypatch, ["--input_root", str(src), "--output",
                                        theirs])
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert filecmp.cmp(ours + ".json", theirs + ".json", shallow=False)
    store = FrameStore(ours)
    assert set(store.keys()) == {f"clip{i}" for i in range(n)}
    np.testing.assert_array_equal(store.get("clip1"),
                                  np.load(src / "clip1.npy"))
    store.close()


def test_build_framestore_skips_unreadable_inputs(tmp_path):
    src = _clip_folder(tmp_path / "vids", n=2)
    (src / "broken.npy").write_bytes(b"not a numpy file")
    out = str(tmp_path / "p.fstore")
    assert build_framestore.main(["--input_root", str(src), "--output",
                                  out]) == 2


# ------------------------------------------------------ check / paths
def test_check_video_reports_what_the_jax_tool_reports(tmp_path,
                                                       monkeypatch):
    root = tmp_path / "vids"
    root.mkdir()
    np.save(root / "good.npy", np.zeros((4, 8, 8, 3), np.uint8))
    np.save(root / "flat.npy", np.zeros((8, 8, 3), np.uint8))     # 3-D
    (root / "broken.npy").write_bytes(b"not a numpy file")
    (root / "clip.mp4").write_bytes(b"\x00" * 64)
    build_framestore.main(["--input_root", str(_clip_folder(
        tmp_path / "src", n=2)), "--output", str(root / "ok.fstore")])
    broken = check_video.main(["--input_root", str(root)])
    assert broken == _run_jax_main(jax_cv, monkeypatch,
                                   ["--input_root", str(root)])
    assert sorted(os.path.basename(b) for b in broken) == [
        "broken.npy", "clip.mp4", "flat.npy", "ok.fstore.json"]


def test_generate_video_path_equals_the_jax_tool(tmp_path, monkeypatch):
    root = tmp_path / "vids"
    (root / "sub").mkdir(parents=True)
    np.save(root / "a.npy", np.zeros((1, 4, 4, 3), np.uint8))
    np.save(root / "sub" / "b.npy", np.zeros((1, 4, 4, 3), np.uint8))
    (root / "sub" / "c.MP4").write_bytes(b"")
    (root / "notes.txt").write_text("x")
    ours, theirs = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    mapping = generate_video_path.main(["--features_path", str(root),
                                        "--output", ours])
    _run_jax_main(jax_gvp, monkeypatch, ["--features_path", str(root),
                                         "--output", theirs])
    assert filecmp.cmp(ours, theirs, shallow=False)
    assert mapping == {"a": "a.npy", "b": os.path.join("sub", "b.npy"),
                       "c": os.path.join("sub", "c.MP4")}


# ------------------------------------------------- gated back-ends
class _Parsed(Exception):
    pass


def _parser_of(call, monkeypatch):
    """The ArgumentParser a tool's main() builds (stopped at parse_args)."""
    seen = []

    def stop(self, *a, **k):
        seen.append(self)
        raise _Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed):
        call()
    monkeypatch.undo()
    return seen[0]


def _flags(parser):
    return [(a.option_strings, a.dest, a.default, a.type, a.required,
             a.choices, a.nargs) for a in parser._actions]


@pytest.mark.parametrize("mod", [
    "build_framestore", "check_video", "compress_video", "download_lsmdc",
    "folder2lmdb", "generate_video_path", "visualize_clusters"])
def test_every_tool_has_the_jax_tools_flags(mod, monkeypatch):
    port = importlib.import_module(f"centerclip_tpu_torch.preprocess.{mod}")
    ref = importlib.import_module(f"centerclip_tpu.preprocess.{mod}")
    ours = _flags(_parser_of(lambda: port.main([]), monkeypatch))
    theirs = _flags(_parser_of(
        lambda: ref.main([]) if mod == "visualize_clusters" else ref.main(),
        monkeypatch))
    assert ours == theirs and len(ours) >= 2


def test_compress_video_gate_and_commands(tmp_path, monkeypatch):
    src = tmp_path / "raw"
    src.mkdir()
    (src / "a.mp4").write_bytes(b"")
    (src / "b.avi").write_bytes(b"")
    out = tmp_path / "out"
    argv = ["--input_root", str(src), "--output_root", str(out),
            "--num_works", "1"]
    for tool in (compress_video, jax_compress):
        monkeypatch.setattr(tool.shutil, "which", lambda _: None)
    with pytest.raises(SystemExit, match="ffmpeg not found on PATH"):
        compress_video.main(argv)
    with pytest.raises(SystemExit, match="ffmpeg not found on PATH"):
        _run_jax_main(jax_compress, monkeypatch, argv)
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(compress_video.shutil, "which",
                        lambda _: "/bin/ffmpeg")

    def recording(name):
        def run(cmd, *a, **k):
            calls[name].append(cmd)
            return type("P", (), {"returncode": int("b.avi" in cmd[3])})()
        monkeypatch.setattr(compress_video.subprocess, "run", run)
    recording("port")
    failed = compress_video.main(argv)
    recording("jax")
    _run_jax_main(jax_compress, monkeypatch, argv)
    assert sorted(calls["port"]) == sorted(calls["jax"]) and \
        len(calls["port"]) == 2
    assert failed == [str(out / "b.avi")]
    assert calls["port"][0][:3] == ["ffmpeg", "-y", "-i"]


def test_download_lsmdc_runs_the_jax_tools_commands(tmp_path, monkeypatch):
    urls = tmp_path / "urls.txt"
    urls.write_text("https://example.invalid/clips/a.avi\n\n"
                    "https://example.invalid/clips/b.avi\n")
    out = tmp_path / "dl"
    out.mkdir()
    (out / "b.avi").write_bytes(b"")              # already there: no call
    argv = ["--url_list", str(urls), "--output_dir", str(out),
            "--user", "u", "--password", "p", "--num_works", "1"]
    calls = {"port": [], "jax": []}

    def recording(name):
        def run(cmd, *a, **k):
            calls[name].append(cmd)
            return type("P", (), {"returncode": 0})()
        monkeypatch.setattr(download_lsmdc.subprocess, "run", run)
    recording("port")
    assert download_lsmdc.main(argv) == 0
    recording("jax")
    _run_jax_main(jax_dl, monkeypatch, argv)
    assert calls["port"] == calls["jax"] == [
        ["wget", "-q", "--user=u", "--password=p", "-O",
         str(out / "a.avi"), "https://example.invalid/clips/a.avi"]]


def test_folder2lmdb_raises_the_jax_tools_error_without_lmdb(tmp_path,
                                                             monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    src = _clip_folder(tmp_path / "vids", n=1)
    argv = ["--input_root", str(src), "--output", str(tmp_path / "x.lmdb")]
    with pytest.raises(ImportError) as ours:
        folder2lmdb.main(argv)
    with pytest.raises(ImportError) as theirs:
        _run_jax_main(importlib.import_module(
            "centerclip_tpu.preprocess.folder2lmdb"), monkeypatch, argv)
    assert type(ours.value) is type(theirs.value)


def _write_avi(path, frames, fps):
    import cv2
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"),
                             fps, (w, h))
    for f in frames:
        writer.write(f[..., ::-1].copy())
    writer.release()


def test_cv2_extractor_equals_the_jax_one_and_is_gated(tmp_path,
                                                       monkeypatch):
    frames = np.random.default_rng(3).integers(0, 255, (12, 48, 64, 3),
                                               dtype=np.uint8)
    path = tmp_path / "clip.avi"
    _write_avi(path, frames, fps=4)
    for kw in ({}, {"start_time": 1, "end_time": 2}):
        ours, n = cv2_decode.RawVideoExtractorCV2(
            size=32, framerate=2).get_video_data(str(path), **kw)
        ref, n_ref = jax_cv2.RawVideoExtractorCV2(
            size=32, framerate=2).get_video_data(str(path), **kw)
        assert n == n_ref > 0 and ours.shape == (n, 3, 32, 32)
        np.testing.assert_array_equal(ours, ref)
    monkeypatch.setattr(cv2_decode, "HAS_CV2", False)
    monkeypatch.setattr(jax_cv2, "HAS_CV2", False)
    for mod in (cv2_decode, jax_cv2):
        with pytest.raises(RuntimeError, match="OpenCV"):
            mod.RawVideoExtractorCV2()


# ------------------------------------------------ visualize_clusters
def _synthetic_clip(tmp_path, T=4, hw=224):
    """tests/test_preprocess.py's clusterable clip: quadrant colours."""
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 40, size=(T, hw, hw, 3)).astype(np.uint8)
    clip[:, : hw // 2, : hw // 2, 0] += 200
    clip[:, : hw // 2, hw // 2:, 1] += 200
    clip[:, hw // 2:, : hw // 2, 2] += 200
    path = tmp_path / "clip.npy"
    np.save(path, clip)
    return str(path)


def _same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n
    return names


@pytest.mark.parametrize("mode,extra", [
    ("patches", []),
    ("mask", ["--segment_frames", "2", "--cluster_num", "8",
              "--save_ids", "1"]),
    ("overlay", ["--segment_frames", "2", "--cluster_num", "8"])])
def test_visualize_clusters_writes_the_jax_tools_files(tmp_path, mode,
                                                       extra):
    video = _synthetic_clip(tmp_path)
    argv = ["--video", video, "--mode", mode, "--max_frames", "4"] + extra
    visualize_clusters.main(argv + ["--output_dir", str(tmp_path / "p")],
                            device="cpu")
    jax_vc.main(argv + ["--output_dir", str(tmp_path / "j")])
    names = _same_tree(tmp_path / "p", tmp_path / "j")
    assert "crop-4.png" in names
    if mode == "mask":
        assert np.load(tmp_path / "p" / "ids_0.npy").shape == (2, 8)


def test_visualize_clusters_renders_a_saved_ids_dump(tmp_path):
    video = _synthetic_clip(tmp_path)
    argv = ["--video", video, "--mode", "mask", "--max_frames", "4"]
    visualize_clusters.main(argv + ["--output_dir", str(tmp_path / "a"),
                                    "--segment_frames", "2",
                                    "--cluster_num", "8", "--save_ids", "1"],
                            device="cpu")
    ids = str(tmp_path / "a" / "ids_0.npy")
    visualize_clusters.main(argv + ["--output_dir", str(tmp_path / "b"),
                                    "--id_path", ids], device="cpu")
    jax_vc.main(argv + ["--output_dir", str(tmp_path / "c"), "--id_path",
                        ids])
    for i in (1, 4):
        name = f"crop-masked-{i}.png"
        assert filecmp.cmp(tmp_path / "a" / name, tmp_path / "b" / name,
                           shallow=False)
        assert filecmp.cmp(tmp_path / "b" / name, tmp_path / "c" / name,
                           shallow=False)


def test_pixel_token_medoids_equal_jax_at_the_tools_default_shape():
    """12 frames in segments of 2 -> [6, 98, 3072] pixel tokens, K = 49,
    iter_limit 60: the medoid ids the port's tool picks (the plain
    k-medoids on the CPU) equal the JAX tool's.  The frames are seeded
    0 / 255 pixels, each segment's second frame the first one's
    complement, so every coordinate's mean over a segment's 98 tokens is
    exactly 0.5 and the distance matmul is exact in fp32 on both sides;
    on other pixels the two packages' distances agree only to rounding,
    which decides 2-point clusters' medoids (ROADMAP.md, "Distances at
    N > 25 agree only to rounding")."""
    g = np.random.default_rng(4)
    first = g.integers(0, 2, (6, 224, 224, 3)).astype(np.uint8) * 255
    frames = np.stack([first, 255 - first], axis=1).reshape(12, 224, 224, 3)
    tokens, dur = visualize_clusters.pixel_tokens(frames, 6)
    assert tokens.shape == (6, 98, 3072) and dur == 2
    np.testing.assert_array_equal(tokens.mean(axis=1), 0.5)
    assign, meds, d = visualize_clusters._cluster(frames, 49, 6,
                                                  device="cpu")
    ref_assign, ref_meds, ref_d = jax_vc._cluster(frames, 49, 6)
    assert d == ref_d == 2 and meds.shape == (6, 49)
    np.testing.assert_array_equal(meds, ref_meds)
    np.testing.assert_array_equal(assign, ref_assign)


def test_visualize_clusters_needs_a_card_unless_told_cpu(tmp_path,
                                                         monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        visualize_clusters.main(["--video", _synthetic_clip(tmp_path),
                                 "--output_dir", str(tmp_path / "o"),
                                 "--max_frames", "4", "--cluster_num", "8",
                                 "--segment_frames", "2"])


# ------------------------------------------------------------ file cache
def test_cache_names_and_helpers_equal_jax(tmp_path):
    for url, etag in (("http://x/y", None), ("http://x/y", '"abc"'),
                      ("s3://b/k.tar.gz", "e")):
        assert file_cache.url_to_filename(url, etag) == \
            jax_fc.url_to_filename(url, etag)
    assert file_cache.split_s3_path("s3://bucket/a/b.txt") == \
        ("bucket", "a/b.txt")
    with pytest.raises(ValueError):
        file_cache.split_s3_path("s3://bucket-only")
    assert file_cache.get_file_extension("a/b/C.NPY") == ".npy"
    assert file_cache.get_file_extension("a/b/C.NPY", dot=False,
                                         lower=False) == "NPY"
    p = tmp_path / "skip.txt"
    p.write_text("vid1\nvid2\nvid1\n")
    assert file_cache.read_set_from_file(p) == {"vid1", "vid2"}
    f = tmp_path / "weights.pt"
    f.write_bytes(b"x")
    assert file_cache.cached_path(f) == str(f)
    with pytest.raises(FileNotFoundError):
        file_cache.cached_path(tmp_path / "missing.pt")
    with pytest.raises(ValueError):
        file_cache.cached_path("gopher://weird/scheme")
    assert file_cache.CACHE_DIR == jax_fc.CACHE_DIR


class _Handler(BaseHTTPRequestHandler):
    payload = b"payload-v1"
    etag = '"etag-1"'
    hits = {"GET": 0, "HEAD": 0}

    def _head(self):
        self.send_response(200)
        self.send_header("ETag", self.etag)
        self.send_header("Content-Length", str(len(self.payload)))
        self.end_headers()

    def do_HEAD(self):
        self.hits["HEAD"] += 1
        self._head()

    def do_GET(self):
        self.hits["GET"] += 1
        self._head()
        self.wfile.write(self.payload)

    def log_message(self, *args):
        pass


@pytest.fixture
def http_server():
    server = HTTPServer(("127.0.0.1", 0), _Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    _Handler.hits = {"GET": 0, "HEAD": 0}
    try:
        yield f"http://127.0.0.1:{server.server_port}"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


def test_one_cache_directory_serves_both_packages(http_server, tmp_path):
    """The port downloads once per ETag; the JAX package then finds the
    port's entry (no GET), heals a missing sidecar, and a new ETag is a
    new entry."""
    url = http_server + "/weights.bin"
    cache = tmp_path / "cache"
    path = file_cache.get_from_cache(url, cache)
    assert open(path, "rb").read() == b"payload-v1"
    assert _Handler.hits["GET"] == 1
    assert jax_fc.get_from_cache(url, cache) == path
    assert file_cache.cached_path(url, cache) == path
    assert _Handler.hits["GET"] == 1
    assert file_cache.filename_to_url(os.path.basename(path), cache) == \
        jax_fc.filename_to_url(os.path.basename(path), cache) == \
        (url, '"etag-1"')
    os.unlink(path + ".json")
    assert file_cache.get_from_cache(url, cache) == path
    assert json.load(open(path + ".json")) == {"url": url,
                                               "etag": '"etag-1"'}
    _Handler.etag, _Handler.payload = '"etag-2"', b"payload-v2"
    try:
        path2 = file_cache.get_from_cache(url, cache)
    finally:
        _Handler.etag, _Handler.payload = '"etag-1"', b"payload-v1"
    assert path2 != path and open(path2, "rb").read() == b"payload-v2"
    assert not [n for n in os.listdir(cache) if n.endswith(".download")]


def _make_targz(tmp_path, cfg):
    arch = tmp_path / "cross-small.tar.gz"
    raw = json.dumps(cfg).encode()
    with tarfile.open(arch, "w:gz") as tf:
        info = tarfile.TarInfo("cross_config.json")
        info.size = len(raw)
        tf.addfile(info, io.BytesIO(raw))
    return arch


def test_archives_and_cross_config_resolve_as_in_jax(tmp_path):
    cfg = {"hidden_size": 256, "num_hidden_layers": 2, "hidden_act": "gelu"}
    arch = _make_targz(tmp_path, cfg)
    d, tempdir = file_cache.resolve_archive_dir(arch)
    try:
        assert tempdir == d
        assert json.load(open(os.path.join(d, "cross_config.json"))) == cfg
    finally:
        import shutil
        shutil.rmtree(tempdir)
    assert file_cache.resolve_archive_dir(tmp_path) == (str(tmp_path), None)
    for name, over in (("cross-base", {}),
                       ("cross-base", dict(hidden_size=640,
                                           num_hidden_layers=2)),
                       (str(arch), {})):
        ours = cross.CrossConfig.get_config(name, **over)
        ref = jax_cross.CrossConfig.get_config(name, **over)
        assert ours.__dict__ == ref.__dict__
    assert cross.CrossConfig.get_config("cross-base") == cross.CrossConfig()


# ------------------------------------------------------------------ misc
def test_misc_helpers(tmp_path):
    g = misc.set_random_seed(5)
    a = np.random.random()
    jax_misc.set_random_seed(5)
    assert np.random.random() == a
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(5)))
    net = torch.nn.Sequential(torch.nn.Linear(3, 4),
                              torch.nn.BatchNorm1d(4))
    assert misc.count_params(net) == 3 * 4 + 4 + 4 + 4
    assert misc.count_params_million(net) == pytest.approx(24e-6)
    misc.convert_params_to_bf16(net)
    assert net[0].weight.dtype == torch.bfloat16
    assert net[1].running_mean.dtype == torch.bfloat16
    assert net[1].num_batches_tracked.dtype == torch.int64
    misc.convert_params_to_fp32(net)
    assert all(p.dtype == torch.float32 for p in net.parameters())
