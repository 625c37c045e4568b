"""REST serving: POST an image, get oriented detections as JSON.

    python -m yolov5_obb_tpu_torch.serve --weights runs/train/exp/best \\
        --cfg yolov5m.yaml --port 5000 [--dtype bfloat16] [--device cpu]
    curl -X POST --data-binary @img.png http://localhost:5000/v1/obb-detection

Counterpart of ``yolov5_obb_tpu/serve.py`` (the reference Flask endpoint,
utils/flask_rest_api/restapi.py:14-37): a standard-library
``ThreadingHTTPServer`` whose handlers hand each image to one worker thread
that owns the model and batches the requests waiting (up to 8) into one
call.  Bodies decode through ``utils/image_io.py``: PNG needs no OpenCV; an
undecodable body, or another format on a machine without OpenCV, gets 400.
The reply is the image's rows of :func:`~.api.detection_rows`.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from .api import OBBModel, detection_rows
from .utils import image_io
from .utils.general import load_dataset_config


class _Worker(threading.Thread):
    """The one thread that owns the model; requests arrive through a
    queue.  ``batch_sizes`` records the size of every batch it formed."""

    def __init__(self, model, max_batch: int = 8):
        super().__init__(daemon=True)
        self.model = model
        self.max_batch = max_batch
        self.q: queue.Queue = queue.Queue()
        self.batch_sizes: list = []

    def run(self):
        while True:
            # dynamic batching: one request, then whatever else is already
            # queued (up to max_batch) into the same model call
            batch = [self.q.get()]
            while len(batch) < self.max_batch:
                try:
                    batch.append(self.q.get_nowait())
                except queue.Empty:
                    break
            self.batch_sizes.append(len(batch))
            try:
                dets = self.model([img for img, _ in batch])
                for (_, reply), p, c, k in zip(batch, dets.polys, dets.confs,
                                               dets.clses):
                    reply.put(("ok", detection_rows(p, c, k, dets.names)))
            except Exception as e:  # noqa: BLE001 — report it to the client
                for _, reply in batch:
                    reply.put(("error", str(e)))

    def infer(self, img, timeout=600.0):
        reply: queue.Queue = queue.Queue()
        self.q.put((img, reply))
        try:
            return reply.get(timeout=timeout)
        except queue.Empty:
            return "error", f"inference timed out after {timeout:.0f}s"


def make_handler(worker: _Worker):
    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if not self.path.startswith("/v1/obb-detection"):
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            blob = self.rfile.read(length)
            try:
                img = image_io.imdecode(blob)
            except image_io.OpenCVUnavailable as e:
                self.send_error(400, str(e))
                return
            if img is None:
                self.send_error(400, "not a decodable image")
                return
            status, payload = worker.infer(img)
            body = json.dumps(payload).encode()
            self.send_response(200 if status == "ok" else 500)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def parse_opt(argv=None):
    p = argparse.ArgumentParser(prog="python -m yolov5_obb_tpu_torch.serve")
    p.add_argument("--weights", default="",
                   help="checkpoint directory or state-dict .pt; empty: "
                        "random weights")
    p.add_argument("--cfg", default="yolov5m.yaml")
    p.add_argument("--data", default=None, help="dataset yaml (names)")
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=5000)
    return p.parse_args(argv)


def main(argv=None):
    a = parse_opt(argv)
    names = load_dataset_config(a.data)["names"] if a.data else None
    model = OBBModel(
        cfg=a.cfg, weights=a.weights or None, names=names, imgsz=a.imgsz,
        conf_thres=a.conf_thres, device=a.device,
        dtype=torch.bfloat16 if a.dtype == "bfloat16" else torch.float32)
    worker = _Worker(model)
    worker.start()
    server = ThreadingHTTPServer((a.host, a.port), make_handler(worker))
    print(f"serving OBB detection on :{server.server_address[1]}"
          "/v1/obb-detection")
    server.serve_forever()


if __name__ == "__main__":
    main()
