# coding=utf-8
"""The port's data layer against the JAX package's, on seeded numpy
fixtures (the shapes of tests/test_data.py and tests/test_datasets_extra.py,
cut to small frames).

Everything here is host code, so the bar is equality: sampled indices,
transforms, FrameStore files, the C++ reader's batches (the port's copy is
built here with the host compiler), dataset items and whole epochs of the
registry's loaders must equal the JAX package's byte for byte.
"""
import csv
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from centerclip_tpu import config as jax_config
from centerclip_tpu.data import datasets as jax_datasets
from centerclip_tpu.data import decode as jax_decode
from centerclip_tpu.data import framestore as jax_framestore
from centerclip_tpu.data import loader as jax_loader
from centerclip_tpu.data import native as jax_native
from centerclip_tpu.data import registry as jax_registry
from centerclip_tpu.data import transforms as jax_transforms
from centerclip_tpu.models.tokenizer import SimpleTokenizer as JaxTokenizer
from centerclip_tpu.ops import sampling as jax_sampling
from centerclip_tpu_torch import config as port_config
from centerclip_tpu_torch.data import datasets, decode, framestore, loader
from centerclip_tpu_torch.data import native, registry, transforms
from centerclip_tpu_torch.data.fast_dataset import FrameStoreClipDataset
from centerclip_tpu_torch.models.tokenizer import SimpleTokenizer
from centerclip_tpu_torch.ops import _build
from centerclip_tpu_torch.ops import sampling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 32                      # crop size: frames of 40 x 48 pad on one side


@pytest.fixture(scope="module")
def toks():
    return JaxTokenizer(), SimpleTokenizer()


def assert_same_batch(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def _frames(T, H=40, W=48, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, size=(T, H, W, 3), dtype=np.uint8)


# ------------------------------------------------------------- sampling
@pytest.mark.parametrize("clip_length,num_frames,data_length", [
    (12, 48, 1), (12, 13, 1), (12, 12, 1), (12, 5, 1), (4, 30, 3),
    (6, 8, 2)])
@pytest.mark.parametrize("random_shift", [True, False])
def test_sampling_indices_equal(clip_length, num_frames, data_length,
                                random_shift):
    for seed in range(5):
        a = jax_sampling.multi_segments_sampling(
            clip_length, num_frames, random_shift, data_length,
            rng=np.random.default_rng(seed))
        b = sampling.multi_segments_sampling(
            clip_length, num_frames, random_shift, data_length,
            rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.int64
        a = jax_sampling.token_sparse_sampling(
            clip_length, num_frames, random_shift,
            rng=np.random.default_rng(seed))
        b = sampling.token_sparse_sampling(
            clip_length, num_frames, random_shift,
            rng=np.random.default_rng(seed))
        np.testing.assert_array_equal(a, b)
    for twice in (False, True):
        np.testing.assert_array_equal(
            jax_sampling.uniform_sampling(clip_length, num_frames,
                                          data_length, twice),
            sampling.uniform_sampling(clip_length, num_frames, data_length,
                                      twice))


# ----------------------------------------------------------- transforms
@pytest.mark.parametrize("H,W", [(40, 48), (32, 32), (24, 41), (60, 33)])
def test_transforms_equal(H, W):
    frames = list(_frames(3, H, W, seed=H + W))
    for name in ("clip_eval_transform", "clip_transform_uint8"):
        a = getattr(jax_transforms, name)(frames, RES)
        b = getattr(transforms, name)(frames, RES)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        jax_transforms.clip_train_transform(frames, RES),
        transforms.clip_train_transform(frames, RES))
    x = transforms.group_to_bchw(frames)
    np.testing.assert_array_equal(jax_transforms.group_to_bchw(frames), x)
    np.testing.assert_array_equal(jax_transforms.normalize(x),
                                  transforms.normalize(x))
    for out_hw in ((RES, RES), (17, 29), (H, W)):
        np.testing.assert_array_equal(
            jax_transforms._resize_bilinear(x, *out_hw),
            transforms._resize_bilinear(x, *out_hw))
    for seed in range(4):
        np.testing.assert_array_equal(
            jax_transforms.multi_scale_crop(x, RES,
                                            rng=np.random.default_rng(seed)),
            transforms.multi_scale_crop(x, RES,
                                        rng=np.random.default_rng(seed)))
        np.testing.assert_array_equal(
            jax_transforms.random_horizontal_flip(
                x, rng=np.random.default_rng(seed)),
            transforms.random_horizontal_flip(
                x, rng=np.random.default_rng(seed)))
    assert transforms.CLIP_MEAN == jax_transforms.CLIP_MEAN
    assert transforms.CLIP_STD == jax_transforms.CLIP_STD


# ----------------------------------------------------------- FrameStore
# mixed sizes: bigger than the crop, exactly the crop, smaller (pad), odd
SIZES = [(60, 80), (RES, RES), (20, 36), (41, 33)]


@pytest.fixture(scope="module")
def videos():
    return {f"vid{i}": _frames(8 + i, h, w, seed=i)
            for i, (h, w) in enumerate(SIZES)}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_framestore_files_read_in_both_packages(tmp_path, videos, writer):
    build = (jax_framestore if writer == "jax" else framestore
             ).build_framestore
    path = build(videos, str(tmp_path / "v.fstore"))
    for mod in (jax_framestore, framestore):
        store = mod.FrameStore(path)
        assert list(store.keys()) == list(videos)
        for k, v in videos.items():
            np.testing.assert_array_equal(store.get(k), v)
        store.close()
    ns = native.NativeFrameStore(path)
    assert len(ns) == len(videos)
    for k, v in videos.items():
        assert ns.entry_info(ns.entry_id(k)) == v.shape


def test_framestore_writers_write_the_same_bytes(tmp_path, videos):
    a = jax_framestore.build_framestore(videos, str(tmp_path / "a.fstore"))
    b = framestore.build_framestore(videos, str(tmp_path / "b.fstore"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    with open(a + ".json") as fa, open(b + ".json") as fb:
        assert json.load(fa) == json.load(fb)


@pytest.fixture(scope="module")
def store_path(tmp_path_factory, videos):
    return framestore.build_framestore(
        videos, str(tmp_path_factory.mktemp("fs") / "v.fstore"))


@pytest.mark.parametrize("size", [RES, 56])
@pytest.mark.parametrize("threads", [1, 3])
def test_cpp_reader_equals_python_and_jax_reader(store_path, videos, size,
                                                 threads):
    """The port's reader (built here by the host compiler) against the
    Python transforms and the JAX package's reader; frame indices out of
    range are clamped."""
    keys = list(videos)
    rng = np.random.default_rng(size + threads)
    idx = np.stack([rng.integers(-2, len(videos[k]) + 3, size=5)
                    for k in keys])
    ns = native.NativeFrameStore(store_path, num_threads=threads)
    eids = [ns.entry_id(k) for k in keys]
    f32 = ns.gather_batch(eids, idx, size=size)
    u8 = ns.gather_batch_u8(eids, idx, size=size)
    assert f32.shape == u8.shape == (len(keys), 5, 3, size, size)
    for b, k in enumerate(keys):
        clamped = np.clip(idx[b], 0, len(videos[k]) - 1)
        frames = [videos[k][i] for i in clamped]
        np.testing.assert_array_equal(
            u8[b], transforms.clip_transform_uint8(frames, size))
        np.testing.assert_allclose(
            f32[b], transforms.clip_eval_transform(frames, size),
            rtol=1e-5, atol=1e-5)
    ref = jax_native.NativeFrameStore(store_path, num_threads=threads)
    np.testing.assert_array_equal(u8, ref.gather_batch_u8(eids, idx,
                                                          size=size))
    # the JAX package's checked-in library is built with -march=native,
    # where the compiler fuses (x / 255 - mean) / std into FMAs: one fp32
    # ulp apart (the main path ships the uint8 batch, equal to the byte)
    np.testing.assert_allclose(f32, ref.gather_batch(eids, idx, size=size),
                               rtol=2.4e-7, atol=2.4e-7)


def test_cpp_reader_writes_into_out_buffers(store_path, videos):
    ns = native.NativeFrameStore(store_path)
    idx = np.zeros((2, 3), np.int64)
    want = ns.gather_batch_u8([0, 1], idx, size=RES)
    out = np.full((2, 3, 3, RES, RES), 7, np.uint8)
    assert ns.gather_batch_u8([0, 1], idx, size=RES, out=out) is out
    np.testing.assert_array_equal(out, want)
    outf = np.empty((2, 3, 3, RES, RES), np.float32)
    assert ns.gather_batch([0, 1], idx, size=RES, out=outf) is outf
    for bad in (np.empty((2, 3, 3, RES, RES), np.float32),       # dtype
                np.empty((2, 3, 3, RES, RES + 1), np.uint8),     # shape
                np.empty((2, 3, 3, RES, 2 * RES), np.uint8)[..., ::2]):
        with pytest.raises(ValueError):
            ns.gather_batch_u8([0, 1], idx, size=RES, out=bad)
    with pytest.raises(KeyError):
        ns.entry_id("nope")
    with pytest.raises(ValueError):
        ns.gather_batch_u8([0], idx, size=RES)            # [B] vs [B, T]


def test_cpp_reader_refuses_empty_entries(tmp_path):
    path = framestore.build_framestore(
        {"empty": np.zeros((0, 8, 8, 3), np.uint8),
         "one": _frames(1, 8, 8)}, str(tmp_path / "e.fstore"))
    ns = native.NativeFrameStore(path)
    assert ns.num_frames("empty") == 0
    ns.gather_batch_u8([ns.entry_id("one")], np.zeros((1, 2), np.int64),
                       size=8)
    with pytest.raises(RuntimeError, match="code 3"):
        ns.gather_batch_u8([ns.entry_id("empty")],
                           np.zeros((1, 2), np.int64), size=8)


@pytest.mark.parametrize("damage", ["index_off", "entry_offset",
                                    "truncated_index", "short"])
def test_cpp_reader_refuses_corrupt_stores(tmp_path, videos, damage):
    """A store whose header or index points past its end is refused with
    IOError (the JAX package's reader reads past the mapping there).  Run
    in a subprocess so that a reader which crashes fails the test instead
    of the test process."""
    path = framestore.build_framestore(videos, str(tmp_path / "c.fstore"))
    data = bytearray(open(path, "rb").read())
    index_off = int.from_bytes(data[16:24], "little")
    if damage == "index_off":
        data[16:24] = (1 << 40).to_bytes(8, "little")
    elif damage == "entry_offset":
        # the first entry's u64 offset sits after u16 klen, key, 4 x u32
        klen = int.from_bytes(data[index_off:index_off + 2], "little")
        at = index_off + 2 + klen + 16
        data[at:at + 8] = (index_off - 10).to_bytes(8, "little")
    elif damage == "truncated_index":
        data = data[:index_off + 5]
    else:
        data = data[:10]
    open(path, "wb").write(bytes(data))
    code = ("import sys\n"
            "from centerclip_tpu_torch.data.native import NativeFrameStore\n"
            "try:\n"
            f"    NativeFrameStore({path!r})\n"
            "except IOError as e:\n"
            "    print('refused:', e)\n"
            "    sys.exit(0)\n"
            "sys.exit(3)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, (res.returncode, res.stderr[-2000:])
    assert "refused" in res.stdout


def test_failed_reader_build_raises_with_compiler_output(tmp_path,
                                                         monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "framestore_reader.cpp").write_text(
        'extern "C" int fs_open( { this is not C++ }\n')
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path / "csrc"))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed for framestore_reader"
                       ".cpp") as err:
        _build.build(["framestore_reader"])
    assert "error" in str(err.value)
    assert os.listdir(tmp_path / "build") == []      # no library left


# -------------------------------------------------------------- decoder
@pytest.fixture(scope="module")
def video_root(tmp_path_factory, videos):
    root = tmp_path_factory.mktemp("videos")
    for k, v in videos.items():
        np.save(root / f"{k}.npy", v)
        (root / k).mkdir()
        for i, frame in enumerate(v):
            from PIL import Image
            Image.fromarray(frame).save(root / k / f"{i:04d}.png")
    framestore.build_framestore(videos, str(root / "all.fstore"))
    return root


@pytest.mark.parametrize("backend", ["npy", "framedir", "framestore"])
@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("emit_uint8", [True, False])
def test_decoder_equals_jax(video_root, backend, is_train, emit_uint8):
    kw = dict(size=RES, is_train=is_train, num_segments=6,
              emit_uint8=emit_uint8)
    a, b = jax_decode.VideoDecoder(**kw), decode.VideoDecoder(**kw)
    for k in ("vid0", "vid2", "vid3"):
        path = {"npy": f"{video_root}/{k}.npy", "framedir":
                f"{video_root}/{k}", "framestore":
                f"{video_root}/all.fstore/{k}"}[backend]
        windows = [(None, None)] + ([(0, 1), (1, 2)] if backend == "npy"
                                    else [])
        for start, end in windows:
            ca, na = a.get_video_data(path, start, end,
                                      rng=np.random.default_rng(3))
            cb, nb = b.get_video_data(path, start, end,
                                      rng=np.random.default_rng(3))
            assert na == nb and ca.dtype == cb.dtype
            np.testing.assert_array_equal(ca, cb)
            for order in (0, 1, 2):
                np.testing.assert_array_equal(
                    a.process_frame_order(ca, order,
                                          rng=np.random.default_rng(4)),
                    b.process_frame_order(cb, order,
                                          rng=np.random.default_rng(4)))


def test_decoder_gates_pyav_and_lmdb(video_root):
    for lmdb_dataset, path in ((None, f"{video_root}/x.mp4"),
                               ("db", f"{video_root}/x.mp4")):
        errs = []
        for mod in (jax_decode, decode):
            dec = mod.VideoDecoder(size=RES, lmdb_dataset=lmdb_dataset)
            if mod.HAS_PYAV:
                pytest.skip("PyAV is installed here")
            with pytest.raises(RuntimeError) as e:
                dec.get_video_data(path)
            errs.append(str(e.value))
        assert errs[0] == errs[1] and "PyAV" in errs[1]


# -------------------------------------------------------------- CSVs
def test_csv_reader_equals_pandas(tmp_path):
    path = tmp_path / "t.csv"
    rows = [["video_id", "sentence", "score", "tag"],
            ["7", 'a man, "quoted", says hi', "0.5", "x1"],
            ["12", "commas, commas, commas", "1", "2"],
            ["-3", 'he said ""no""', "2e3", "y"],
            ["40", "plain words", ".25", "z"]]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(rows[0])
        for r in rows[1:]:
            w.writerow(r)
        f.write("\n")                              # a blank trailing line
    got = datasets.read_csv(str(path))
    df = pd.read_csv(path)
    assert list(got) == list(df.columns)
    for col in df.columns:
        want = df[col].values
        assert got[col] == want.tolist(), col
        assert [type(v) for v in got[col]] == [type(v) for v in
                                               want.tolist()], col
    assert got["video_id"] == [7, 12, -3, 40]
    assert got["sentence"][0] == 'a man, "quoted", says hi'
    with open(tmp_path / "bad.csv", "w") as f:
        f.write("a,b\n1,2,3\n")
    with pytest.raises(ValueError, match="row 2"):
        datasets.read_csv(str(tmp_path / "bad.csv"))


# -------------------------------------------------------------- datasets
@pytest.fixture(scope="module")
def msrvtt_root(tmp_path_factory):
    """tests/test_data.py's fixture: 6 videos of 10-15 frames, 4 eval rows,
    3 captions per video; plus a numeric-id variant and a FrameStore."""
    root = tmp_path_factory.mktemp("msrvtt")
    vids = [f"video{i}" for i in range(6)]
    (root / "videos").mkdir()
    frames = {}
    for i, v in enumerate(vids):
        frames[v] = _frames(10 + i, seed=i)
        np.save(root / "videos" / f"{v}.npy", frames[v])
    framestore.build_framestore(frames, str(root / "videos.fstore"))
    pd.DataFrame({"video_id": vids[:4],
                  "sentence": [f"caption of clip {v}, with a comma"
                               for v in vids[:4]]}
                 ).to_csv(root / "test.csv", index=False)
    pd.DataFrame({"video_id": vids}).to_csv(root / "train.csv", index=False)
    corpus = {"sentences": [{"video_id": v,
                             "caption": f"{v} does something {j}"}
                            for v in vids for j in range(3)],
              "videos": [{"video_id": v, "url": f"x?v=parent_{v}"}
                         for v in vids]}
    with open(root / "MSRVTT_data.json", "w") as f:
        json.dump(corpus, f)
    # numeric ids: pandas parses the column as integers
    (root / "num").mkdir()
    for i in range(3):
        np.save(root / "num" / f"{100 + i}.npy", _frames(9, seed=20 + i))
    pd.DataFrame({"video_id": [100, 101, 102],
                  "sentence": ['"quoted", caption', "two, three", "x"]}
                 ).to_csv(root / "num.csv", index=False)
    with open(root / "num.json", "w") as f:
        json.dump({"sentences": [{"video_id": 100 + i, "caption": f"n {i}"}
                                 for i in range(3) for _ in range(2)]}, f)
    return root


def _kw(tok, **over):
    kw = dict(tokenizer=tok, max_words=16, max_frames=6,
              image_resolution=RES, video_suffix=".npy", seed=5)
    kw.update(over)
    return kw


def _dataset_pairs(cls, args, toks, **over):
    """(JAX dataset, port dataset) of class `cls`, built from the same
    arguments."""
    return (getattr(jax_datasets, cls)(**args, **_kw(toks[0], **over)),
            getattr(datasets, cls)(**args, **_kw(toks[1], **over)))


def _msrvtt_args(name, root):
    num = name.endswith("numeric")
    if name.startswith("msrvtt_eval"):
        return "MSRVTTEvalDataset", dict(
            csv_path=str(root / ("num.csv" if num else "test.csv")),
            features_path=str(root / ("num" if num else "videos")))
    return "MSRVTTTrainDataset", dict(
        csv_path=str(root / ("num.csv" if num else "train.csv")),
        json_path=str(root / ("num.json" if num else "MSRVTT_data.json")),
        features_path=str(root / ("num" if num else "videos")),
        unfold_sentences="unfold" in name)


def _assert_same_items(a, b, epochs=(0, 1)):
    assert len(a) == len(b) > 0
    for attr in ("multi_sentence_per_video", "cut_off_points",
                 "sentence_num", "video_num"):
        assert getattr(a, attr) == getattr(b, attr), attr
    for epoch in epochs:
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for i in range(len(a)):
            assert_same_batch(a[i], b[i])


@pytest.mark.parametrize("name", [
    "msrvtt_eval", "msrvtt_eval_numeric", "msrvtt_train",
    "msrvtt_train_unfold", "msrvtt_train_numeric",
    "msrvtt_train_unfold_numeric"])
@pytest.mark.parametrize("raw_pixels", [True, False])
def test_msrvtt_items_equal(msrvtt_root, toks, name, raw_pixels):
    a, b = _dataset_pairs(*_msrvtt_args(name, msrvtt_root), toks,
                          raw_pixels=raw_pixels,
                          frame_order=2 if "train" in name else 0)
    _assert_same_items(a, b)


def test_msvd_lsmdc_activity_didemo_items_equal(tmp_path, toks):
    # MSVD (tests/test_data.py): lists, raw-captions.pkl, multi-sentence
    root = tmp_path / "msvd"
    (root / "videos").mkdir(parents=True)
    vids = [f"clip{i}" for i in range(4)]
    for i, v in enumerate(vids):
        np.save(root / "videos" / f"{v}.npy", _frames(8, seed=i))
    for split in ("train", "val", "test"):
        (root / f"{split}_list.txt").write_text("\n".join(vids))
    caps = {v: [["a", "cat", "plays"], ["someone", "runs"]][:(i % 2) + 1]
            for i, v in enumerate(vids)}
    with open(root / "raw-captions.pkl", "wb") as f:
        pickle.dump(caps, f)
    for subset in ("train", "test"):
        _assert_same_items(*_dataset_pairs(
            "MSVDDataset", dict(subset=subset, data_path=str(root),
                       features_path=str(root / "videos")), toks))
    # LSMDC (tests/test_data.py): tab-separated annotations
    root = tmp_path / "lsmdc"
    (root / "videos").mkdir(parents=True)
    clips = [f"0001_Movie_{i:02d}.00.00-00.10" for i in range(3)]
    for i, c in enumerate(clips):
        np.save(root / "videos" / f"{c}.npy", _frames(9, seed=i))
    for name in ("LSMDC16_challenge_1000_publictect.csv",
                 "LSMDC16_annos_training.csv"):
        (root / name).write_text("".join(
            f"{c}\t0\t1\t0\t1\tSomeone walks away.\n" for c in clips)
            + "broken line\n")
    (root / "video_path.json").write_text(json.dumps(
        {c: f"{c}.npy" for c in clips}))
    for subset in ("train", "test"):
        _assert_same_items(*_dataset_pairs(
            "LSMDCDataset", dict(subset=subset, data_path=str(root),
                       features_path=str(root / "videos")), toks))
    # ActivityNet (tests/test_datasets_extra.py): paragraphs, time windows
    root = tmp_path / "act"
    (root / "videos").mkdir(parents=True)
    pseudo = [f"v_vid{i}" for i in range(3)] + ["v_NHznDFD3V3k"]
    for i, p in enumerate(pseudo):
        np.save(root / "videos" / f"{p[2:]}.npy", _frames(30, seed=i))
    for split, fname in (("train", "train.json"), ("val", "val_1.json")):
        (root / f"{split}_ids.json").write_text(json.dumps(pseudo))
        (root / fname).write_text(json.dumps(
            {p: {"duration": 7.5 + i,
                 "sentences": [f"first thing {i}.", f"second thing {i}."]}
             for i, p in enumerate(pseudo)}))
    (root / "video_path.json").write_text(json.dumps(
        {p[2:]: f"{p[2:]}.npy" for p in pseudo}))
    for subset in ("train", "val"):
        _assert_same_items(*_dataset_pairs(
            "ActivityNetDataset", dict(subset=subset, data_path=str(root),
                       features_path=str(root / "videos")), toks))
    # DiDeMo (tests/test_datasets_extra.py): whole-video window override
    root = tmp_path / "didemo"
    (root / "videos").mkdir(parents=True)
    vids = [f"flickr_vid_{i}.mp4" for i in range(3)]
    for i, v in enumerate(vids):
        np.save(root / "videos" / f"{v}.npy", _frames(40, seed=i))
    for split in ("train", "test"):
        (root / f"{split}_list.txt").write_text("\n".join(vids))
        (root / f"{split}_data.json").write_text(json.dumps(
            [{"video": v, "description": f"moment {i}-{j}",
              "times": [[0, 2], [1, 3]]}
             for i, v in enumerate(vids) for j in range(2)]))
    for subset in ("train", "test"):
        _assert_same_items(*_dataset_pairs(
            "DiDeMoDataset", dict(subset=subset, data_path=str(root),
                       features_path=str(root / "videos")), toks))


# --------------------------------------------------------------- loaders
def _cfgs(root, threads, features="videos", **over):
    kw = dict(datatype="msrvtt", train_csv=str(root / "train.csv"),
              val_csv=str(root / "test.csv"),
              data_path=str(root / "MSRVTT_data.json"),
              features_path=str(root / features), video_suffix=".npy",
              max_words=16, max_frames=6, batch_size=4, batch_size_val=3,
              num_thread_reader=threads, seed=11,
              expand_msrvtt_sentences=True)
    kw.update(over)
    a, b = jax_config.make_run_config(**kw), port_config.make_run_config(**kw)
    res = dict(image_resolution=RES)
    import dataclasses
    return (dataclasses.replace(a, data=dataclasses.replace(a.data, **res)),
            dataclasses.replace(b, data=dataclasses.replace(b.data, **res)))


@pytest.mark.parametrize("threads", [0, 3])
@pytest.mark.parametrize("features", ["videos", "videos.fstore"])
@pytest.mark.parametrize("expand", [True, False])
def test_registry_epochs_equal_jax(msrvtt_root, toks, threads, features,
                                   expand):
    """Whole epochs of the msrvtt train and val loaders, batch by batch,
    threads off and on; the .fstore path through each package's C++
    reader."""
    jcfg, cfg = _cfgs(msrvtt_root, threads, features,
                      expand_msrvtt_sentences=expand)
    slots_j = jax_registry.DATALOADER_DICT["msrvtt"]
    slots_p = registry.DATALOADER_DICT["msrvtt"]
    assert slots_p["test"] is None and slots_j["test"] is None
    (lj, nj, sj) = slots_j["train"](jcfg, toks[0])
    (lp, np_, sp) = slots_p["train"](cfg, toks[1], device="cpu")
    assert nj == np_ and len(lj) == len(lp) > 0 and not lp.pin_memory
    for epoch in (0, 1):
        sj.set_epoch(epoch)
        sp.set_epoch(epoch)
        bj, bp = list(lj), list(lp)
        assert len(bj) == len(bp) == len(lp)
        for x, y in zip(bj, bp):
            assert_same_batch(x, y)
    (vj, mj), (vp, mp) = (slots_j["val"](jcfg, toks[0]),
                          slots_p["val"](cfg, toks[1], device="cpu"))
    assert mj == mp == 4
    bj, bp = list(vj), list(vp)
    assert [len(b["input_ids"]) for b in bp] == [3, 1]
    for x, y in zip(bj, bp):
        assert_same_batch(x, y)


def test_npy_and_fstore_loaders_give_the_same_eval_batches(msrvtt_root,
                                                           toks):
    _, a = _cfgs(msrvtt_root, 2, "videos")
    _, b = _cfgs(msrvtt_root, 2, "videos.fstore")
    la, _ = registry.DATALOADER_DICT["msrvtt"]["val"](a, toks[1])
    lb, _ = registry.DATALOADER_DICT["msrvtt"]["val"](b, toks[1])
    assert isinstance(lb.dataset, FrameStoreClipDataset)
    for x, y in zip(la, lb):
        assert_same_batch(x, y)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_pin_memory_is_off_on_the_cpu(msrvtt_root, toks, device):
    _, cfg = _cfgs(msrvtt_root, 0)
    slots = registry.DATALOADER_DICT["msrvtt"]
    kw = {} if device is None else {"device": device}
    assert not slots["train"](cfg, toks[1], **kw)[0].pin_memory
    assert not slots["val"](cfg, toks[1], **kw)[0].pin_memory
    assert registry._pin("cuda") and registry._pin(torch.device("cuda:0"))
    batch = next(iter(slots["val"](cfg, toks[1], **kw)[0]))
    assert all(isinstance(v, np.ndarray) for v in batch.values())


class _Toy:
    def __init__(self, n, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"sample {i} is broken")
        return {"input_ids": np.full((1, 4), i, np.int32),
                "video": np.full((1, 2, 3, 4, 4), i, np.uint8),
                "video_mask": np.ones((1, 2), np.int32)}


@pytest.mark.parametrize("count", [1, 3, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_shards_and_shuffles_like_jax(count, shuffle):
    for index in range(count):
        kw = dict(batch_size=3, shuffle=shuffle, drop_last=False, seed=3,
                  process_index=index, process_count=count)
        a = jax_loader.BatchLoader(_Toy(10), **kw)
        b = loader.BatchLoader(_Toy(10), **kw)
        for epoch in (0, 2):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            np.testing.assert_array_equal(a._indices(), b._indices())
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert_same_batch(x, y)


def test_loader_hands_a_sample_error_to_the_consumer():
    """A sample that raises in a decode thread ends the epoch with that
    error (the JAX package's producer thread dies and leaves the consumer
    waiting forever)."""
    lo = loader.BatchLoader(_Toy(20, bad=7), batch_size=4, num_threads=2)
    got = {}

    def consume():
        try:
            got["batches"] = sum(1 for _ in lo)
        except ValueError as e:
            got["error"] = str(e)
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "the consumer hangs"
    assert got == {"error": "sample 7 is broken"}


def test_loader_stops_its_producer_when_the_consumer_stops():
    before = threading.active_count()
    lo = loader.BatchLoader(_Toy(400), batch_size=2, num_threads=2,
                            prefetch=1)
    it = iter(lo)
    next(it)
    it.close()
    deadline = time.time() + 30
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_collate_equals_jax():
    samples = [_Toy(5)[i] for i in range(5)]
    assert_same_batch(jax_loader.collate(samples), loader.collate(samples))
