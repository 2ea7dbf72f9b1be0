# coding=utf-8
"""The OpenCV frame extractor sampled by fps (port of the JAX package's
`data/cv2_decode.py`; reference: dataloaders/rawvideo_util.py:9-99).

The PyAV, `.npy` and FrameStore paths of `data/decode.py` replace it
everywhere; it is kept so the surface matches.  It needs OpenCV (`cv2`),
which neither the test machine nor the card's machine has: building one
without it raises the JAX package's `RuntimeError`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .transforms import clip_eval_transform

try:
    import cv2
    HAS_CV2 = True
except ImportError:
    HAS_CV2 = False


class RawVideoExtractorCV2:
    """Frames resampled to `framerate` per second, CLIP-normalised
    (rawvideo_util.py:9-99)."""

    def __init__(self, centercrop: bool = False, size: int = 224,
                 framerate: float = -1):
        if not HAS_CV2:
            raise RuntimeError("OpenCV (cv2) is not available; use the "
                               "PyAV / npy / FrameStore decode backends")
        self.centercrop = centercrop
        self.size = size
        self.framerate = framerate

    def video_to_tensor(self, video_file: str, sample_fp: float = 0,
                        start_time: Optional[int] = None,
                        end_time: Optional[int] = None) -> dict:
        if start_time is not None or end_time is not None:
            if not (start_time is not None and end_time is not None
                    and start_time > -1 and end_time > start_time):
                raise ValueError(f"bad window [{start_time}, {end_time}]")
        cap = cv2.VideoCapture(video_file)
        frame_count = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 1
        total_duration = (frame_count + fps - 1) // fps
        start_sec, end_sec = 0, total_duration
        if start_time is not None:
            start_sec, end_sec = start_time, min(end_time, total_duration)
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(start_time * fps))
        interval = max(int(fps / sample_fp), 1) if sample_fp > 0 else 1
        frames = []
        try:
            for sec in range(int(start_sec), int(end_sec)):
                sec_base = int(sec * fps)
                for ind in np.arange(0, fps, interval).astype(int):
                    cap.set(cv2.CAP_PROP_POS_FRAMES, sec_base + ind)
                    ret, frame = cap.read()
                    if not ret:
                        break
                    frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        finally:
            cap.release()
        if not frames:
            return {"video": np.zeros((0, 3, self.size, self.size),
                                      np.float32)}
        return {"video": clip_eval_transform(frames, self.size)}

    def get_video_data(self, video_path: str, start_time=None, end_time=None
                       ) -> Tuple[np.ndarray, int]:
        data = self.video_to_tensor(video_path, self.framerate,
                                    start_time, end_time)["video"]
        return data, data.shape[0]
