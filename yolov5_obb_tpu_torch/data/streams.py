"""Threaded stream ingestion for live inference.

Counterpart of ``yolov5_obb_tpu/data/streams.py`` (the reference
``LoadStreams``, utils/datasets.py:241-368): one daemon grabber thread per
source keeps only the latest frame, and the consumer sees a batch of the
current frames.  Sources may be webcam indices ("0"), rtsp/rtmp/http URLs,
local video files or a ``*.streams`` text file of one source a line.
Capture needs OpenCV, imported in the constructor.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np


def is_stream_source(source: str) -> bool:
    """True if ``source`` is handled by :class:`LoadStreams`."""
    s = str(source)
    return (s.isnumeric()
            or s.lower().startswith(("rtsp://", "rtmp://", "http://",
                                     "https://", "tcp://"))
            or s.lower().endswith(".streams"))


class LoadStreams:
    """Iterate batches of the freshest frame of each of N streams.

    Yields ``(names, frames, fps_list)``, ``frames`` a list of BGR arrays
    (one per live source).  Iteration ends when every source has closed, or
    after ``max_frames`` batches if given."""

    def __init__(self, sources="0", vid_stride: int = 1,
                 max_frames: int | None = None):
        import cv2

        s = str(sources)
        if s.lower().endswith(".streams"):
            lines = Path(s).read_text().splitlines()
            self.sources = [ln.strip() for ln in lines if ln.strip()]
        else:
            self.sources = [s]
        self.vid_stride = vid_stride
        self.max_frames = max_frames

        n = len(self.sources)
        self.frames: list[np.ndarray | None] = [None] * n
        self.fps = [30.0] * n
        self.alive = [True] * n
        self.caps = []
        self.threads = []
        self._lock = threading.Lock()

        for i, src in enumerate(self.sources):
            cap = cv2.VideoCapture(int(src) if src.isnumeric() else src)
            if not cap.isOpened():
                raise ConnectionError(f"failed to open stream {src!r}")
            fps = cap.get(cv2.CAP_PROP_FPS)
            self.fps[i] = max(fps if np.isfinite(fps) and fps > 0 else 30.0,
                              1e-3)
            ok, frame = cap.read()
            if not ok or frame is None:
                cap.release()
                raise ConnectionError(f"failed to read from stream {src!r}")
            self.frames[i] = frame
            self.caps.append(cap)
            t = threading.Thread(target=self._grab, args=(i, cap),
                                 daemon=True)
            self.threads.append(t)
            t.start()

    def _grab(self, i, cap):
        n = 0
        while self.alive[i] and cap.isOpened():
            n += 1
            if not cap.grab():  # end of a file source, or a dropped stream
                break
            if n % self.vid_stride == 0:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                with self._lock:
                    self.frames[i] = frame
        self.alive[i] = False

    def __iter__(self):
        count = 0
        # pace to the fastest source so that file-backed streams do not
        # spin on one frame; live sources always serve their latest grab
        interval = 1.0 / max(self.fps)
        while any(self.alive) or count == 0:
            if self.max_frames is not None and count >= self.max_frames:
                break
            with self._lock:
                frames = [f.copy() for f in self.frames if f is not None]
            if not frames:
                break
            yield self.sources, frames, self.fps
            count += 1
            time.sleep(interval)
        self.close()

    def close(self):
        self.alive = [False] * len(self.alive)
        for t in self.threads:
            t.join(timeout=2.0)
        for cap in self.caps:
            cap.release()

    def __len__(self):
        return len(self.sources)
