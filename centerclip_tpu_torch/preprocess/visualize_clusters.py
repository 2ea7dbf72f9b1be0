# coding=utf-8
"""Cluster and patch visualisations (port of the JAX package's
`preprocess/visualize_clusters.py`).

* ``--mode patches``: each frame's centre crop (``crop-{i}.png``) and each
  of its patches as a PNG of its own in a folder per frame (reference:
  preprocess/patch_video.py:40-103).
* ``--mode mask``: ``crop-{i}.png`` and ``crop-masked-{i}.png``, where the
  patches whose token is not a kept medoid are dimmed with a translucent
  gray (reference: preprocess/visualize_video.py:40-99).  The medoid ids
  are computed here by k-medoids on the raw patch pixels, or read from an
  ``ids_*.npy`` dump with ``--id_path``; ``--save_ids`` writes them in that
  format.
* ``--mode overlay``: each patch tinted with its cluster's colour.

The input is anything `data/decode.VideoDecoder` reads: a `.npy` frame
dump, a frame directory, a FrameStore member or a video file (PyAV).  The
k-medoids runs on the card unless the caller asks for the CPU
(`main(argv, device="cpu")`): `ops/kmedoids_cuda.kmedoids`, which launches
kernel E on a CUDA tensor and takes its plain version on the CPU, with the
JAX package's `iter_limit` of 60.

    python -m centerclip_tpu_torch.preprocess.visualize_clusters \\
        --video clip.npy --output_dir out/ --mode mask
"""
from __future__ import annotations

import argparse
import os

import numpy as np

# the JAX package's `batch_fast_kmedoids` default, which its tool runs at
KMEDOIDS_ITER_LIMIT = 60


def colorize(assign: np.ndarray, num_clusters: int) -> np.ndarray:
    """[N] cluster ids -> [N, 3] uint8 colours (a fixed palette)."""
    rng = np.random.default_rng(0)
    palette = rng.integers(40, 255, size=(num_clusters, 3)).astype(np.uint8)
    return palette[assign % num_clusters]


def overlay_clusters(frames: np.ndarray, assign: np.ndarray,
                     tokens_per_frame: int, alpha: float = 0.5) -> np.ndarray:
    """Blend cluster colours over each frame's patch grid.  frames:
    [T, H, W, 3] uint8; assign: [T * tokens_per_frame] ids over the
    frame-major patch tokens."""
    T, H, W, _ = frames.shape
    g = int(tokens_per_frame ** 0.5)
    ph, pw = H // g, W // g
    out = frames.astype(np.float32).copy()
    colors = colorize(assign, int(assign.max()) + 1)
    for t in range(T):
        for p in range(tokens_per_frame):
            y, x = (p // g) * ph, (p % g) * pw
            c = colors[t * tokens_per_frame + p].astype(np.float32)
            out[t, y:y + ph, x:x + pw] = (1 - alpha) * \
                out[t, y:y + ph, x:x + pw] + alpha * c
    return out.clip(0, 255).astype(np.uint8)


def mask_non_medoids(frames: np.ndarray, medoid_ids: np.ndarray,
                     tokens_per_frame: int, frame_duration: int,
                     fill=(192, 192, 192), opacity: float = 170 / 255
                     ) -> np.ndarray:
    """Dim every patch whose token is not a kept medoid.  frames:
    [T, H, W, 3] uint8; medoid_ids: [S, K] ids into each segment's
    frame-major token stream, the reference's ids dump layout
    (visualize_video.py:83-94: t_in_segment * tokens_per_frame + y * grid
    + x)."""
    T, H, W, _ = frames.shape
    g = int(tokens_per_frame ** 0.5)
    ph, pw = H // g, W // g
    out = frames.astype(np.float32).copy()
    fill_arr = np.asarray(fill, np.float32)
    for t in range(T):
        t_in_seg, seg = t % frame_duration, t // frame_duration
        kept = set(int(i) for i in np.asarray(medoid_ids[seg]).ravel())
        for p in range(tokens_per_frame):
            if t_in_seg * tokens_per_frame + p not in kept:
                y, x = (p // g) * ph, (p % g) * pw
                out[t, y:y + ph, x:x + pw] = (
                    (1 - opacity) * out[t, y:y + ph, x:x + pw]
                    + opacity * fill_arr)
    return out.clip(0, 255).astype(np.uint8)


def dump_patch_grid(frame: np.ndarray, out_dir: str, stem: str,
                    patch: int = 32, ext: str = ".png") -> int:
    """Save each patch of one frame as an image of its own, in raster
    order from 1 (patch_video.py:40-69); returns the count."""
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)
    H, W, _ = frame.shape
    cnt = 1
    for y in range(0, H - patch + 1, patch):
        for x in range(0, W - patch + 1, patch):
            Image.fromarray(frame[y:y + patch, x:x + patch]).save(
                os.path.join(out_dir, f"{stem}-{cnt}{ext}"))
            cnt += 1
    return cnt - 1


def _decode_frames(video: str, max_frames: int, size: int = 224
                   ) -> np.ndarray:
    """Decode, sample uniformly, centre-crop -> [T, H, W, 3] uint8."""
    from ..data.decode import VideoDecoder
    dec = VideoDecoder(size=size, is_train=False, num_segments=max_frames,
                       emit_uint8=True)
    clip, _ = dec.get_video_data(video)                # [T, C, H, W] uint8
    return np.transpose(np.asarray(clip), (0, 2, 3, 1))


def pixel_tokens(frames_u8: np.ndarray, segment_frames: int,
                 patch: int = 32):
    """Raw patch pixels as k-medoids points: [T, H, W, 3] uint8 ->
    ([S, dur * g * g, patch * patch * 3] fp32 in [0, 1], dur), segments of
    `dur = T // segment_frames` frames, frame-major."""
    T, H, _, _ = frames_u8.shape
    g = H // patch
    x = frames_u8.astype(np.float32) / 255.0
    tokens = x.reshape(T, g, patch, g, patch, 3)
    tokens = tokens.transpose(0, 1, 3, 2, 4, 5).reshape(T, g * g, -1)
    dur = max(T // max(segment_frames, 1), 1)
    S = T // dur
    return tokens[: S * dur].reshape(S, dur * g * g, -1), dur


def _cluster(frames_u8: np.ndarray, cluster_num: int, segment_frames: int,
             patch: int = 32, device=None):
    """k-medoids on raw patch pixels -> (assign [S, N], medoids [S, K],
    frame_duration): a stand-in for the model's clustering that needs no
    weights (with an ids dump, use --id_path)."""
    import torch
    from .. import resolve_device
    from ..ops.kmedoids_cuda import kmedoids
    seg_tokens, dur = pixel_tokens(frames_u8, segment_frames, patch)
    x = torch.from_numpy(seg_tokens).to(resolve_device(device))
    assign, meds = kmedoids(x, cluster_num, iter_limit=KMEDOIDS_ITER_LIMIT)
    return assign.cpu().numpy(), meds.cpu().numpy(), dur


def main(argv=None, device=None) -> None:
    """The tool; `device` is where k-medoids runs (None: the card)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--video", type=str, required=True,
                        help="video file / .npy frames / frame dir / fstore")
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--mode", type=str, default="mask",
                        choices=["patches", "mask", "overlay"])
    parser.add_argument("--max_frames", type=int, default=12)
    parser.add_argument("--cluster_num", type=int, default=49)
    parser.add_argument("--segment_frames", type=int, default=6,
                        help="segments per clip (12 frames -> 6 segments of "
                             "duration 2, the flagship 12->6 config)")
    parser.add_argument("--patch_size", type=int, default=32)
    parser.add_argument("--id_path", type=str, default="",
                        help="mask mode: load medoid token ids from this "
                             ".npy ([S, K], reference ids dump format) "
                             "instead of clustering raw pixels")
    parser.add_argument("--save_ids", type=int, default=0,
                        help="write computed medoid ids to ids_0.npy "
                             "(reference save_feature_path format)")
    args = parser.parse_args(argv)

    from PIL import Image
    os.makedirs(args.output_dir, exist_ok=True)
    frames = _decode_frames(args.video, args.max_frames)
    T = frames.shape[0]
    tokens_per_frame = (frames.shape[1] // args.patch_size) ** 2

    # every mode writes the centre crops (patch_video.py:97-100)
    for i in range(T):
        Image.fromarray(frames[i]).save(
            os.path.join(args.output_dir, f"crop-{i + 1}.png"))

    if args.mode == "patches":
        n = sum(dump_patch_grid(
            frames[i], os.path.join(args.output_dir, f"crop-{i + 1}"),
            f"crop-{i + 1}", patch=args.patch_size) for i in range(T))
        print(f"wrote {T} crops + {n} patch files to {args.output_dir}")
        return

    if args.mode == "mask" and args.id_path:
        medoid_ids = np.load(args.id_path)
        dur = T // medoid_ids.shape[0]
        assign = None
    else:
        assign, medoid_ids, dur = _cluster(
            frames, args.cluster_num, args.segment_frames, args.patch_size,
            device)
    if args.save_ids:
        np.save(os.path.join(args.output_dir, "ids_0.npy"), medoid_ids)

    if args.mode == "mask":
        masked = mask_non_medoids(frames, medoid_ids, tokens_per_frame, dur)
        for i in range(T):
            Image.fromarray(masked[i]).save(
                os.path.join(args.output_dir, f"crop-masked-{i + 1}.png"))
        print(f"wrote {T} crops + {T} masked frames to {args.output_dir}")
        return

    S = medoid_ids.shape[0]
    for s in range(S):
        seg = overlay_clusters(frames[s * dur:(s + 1) * dur], assign[s],
                               tokens_per_frame)
        for i, frame in enumerate(seg):
            Image.fromarray(frame).save(
                os.path.join(args.output_dir, f"seg{s}_frame{i}.png"))
    print(f"wrote visualisations for {S} segments to {args.output_dir}")


if __name__ == "__main__":
    main()
