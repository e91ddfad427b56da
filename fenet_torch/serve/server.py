"""Stdlib HTTP front end for a deploy checkpoint or artifact on one device
(counterpart of ``fenet/serve/server.py``): a ThreadingHTTPServer whose
handlers enqueue into one :class:`~fenet_torch.serve.batcher.MicroBatcher`,
so concurrent requests share padded device batches.

Endpoints:

- ``GET /healthz``  -> ``{"status": "ok", ...model metadata}``
- ``GET /stats``    -> ``{"served": n, "errors": n}``
- ``POST /predict`` -> body: PNG/JPG bytes; response ``{"points": [[x, y,
  z], ...]}``, or a binary PLY with ``?format=ply``; 400 for a body that
  does not decode, 404 for any other path.

A request is counted before its reply is written, so a client that has its
reply reads a ``/stats`` that includes it (fenet counts after replying).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from fenet_torch.utils.device import full_fp32, resolve_device


def device_forward(module: Callable[[torch.Tensor], torch.Tensor], device) -> Callable:
    """``forward(images)`` for the MicroBatcher and the predict CLI: a
    (b, H, W, 3) uint8 numpy batch goes to ``device`` as uint8 (the module
    casts it there) and ``module``'s result returns still in flight.

    On a card the batch is staged in pinned memory and copied with
    ``non_blocking``, so the host does not wait for the copy, and through it
    for the forward before it: that is what lets the batcher's depth-1
    pipeline overlap an upload with the previous batch's compute. PyTorch's
    caching host allocator hands a pinned block out again only once the copy
    recorded on it has completed. ``inference_mode`` is thread-local, so the
    forward enters it itself, in whichever thread calls it.
    """
    device = torch.device(device)
    full_fp32()  # the float32 fold computes in IEEE float32, as the eval path

    def forward(images: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        if device.type == "cuda":
            x = x.pin_memory().to(device, non_blocking=True)
        with torch.inference_mode():
            return module(x)

    return forward


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def build_forward(deploy_ckpt: str, max_batch: int, device="cuda"):
    """(forward, meta): the deploy forward on one device at the fixed
    serving batch, from a folded checkpoint (``export_deploy --format
    torch``) or, by its ``.pt2`` suffix, a frozen artifact (``--format
    export``)."""
    from fenet_torch.serve.artifact import ARTIFACT_SUFFIX, build_forward_artifact

    if deploy_ckpt.endswith(ARTIFACT_SUFFIX):
        return build_forward_artifact(deploy_ckpt, max_batch, device)
    from fenet_torch.cli.export_deploy import load_deploy_checkpoint

    device = resolve_device(device)
    gen, dtype = load_deploy_checkpoint(deploy_ckpt, device)
    meta = {"num_points": gen.num_points, "backbone": gen.backbone,
            "dtype": dtype_name(dtype), "max_batch": int(max_batch), "devices": 1}
    return device_forward(lambda x: gen(x)[2], device), meta


class _Server(ThreadingHTTPServer):
    # The stdlib's listen backlog of 5 drops the connections of a burst of
    # clients beyond it, and TCP retries them after 1, 3, 7 s (a 3.2 s p99
    # with 64 clients on an H100 host).
    request_queue_size = 1024


class _Stats:
    def __init__(self):
        self.lock = threading.Lock()
        self.served = 0
        self.errors = 0

    def bump(self, ok: bool):
        with self.lock:
            if ok:
                self.served += 1
            else:
                self.errors += 1

    def snapshot(self):
        with self.lock:
            return {"served": self.served, "errors": self.errors}


def make_server(deploy_ckpt: str, host: str = "127.0.0.1", port: int = 8471,
                max_batch: int = 32, window_ms: float = 5.0, device="cuda",
                forward=None, meta: Optional[dict] = None):
    """A ready-to-serve ThreadingHTTPServer (the caller runs
    ``serve_forever()``; shut down with ``server.shutdown()`` and
    ``server.batcher.close()``).

    ``forward``/``meta`` may be given (tests, instrumented runs); by default
    they come from :func:`build_forward` on ``device``."""
    from fenet_torch.serve.batcher import MicroBatcher

    if forward is None:
        forward, meta = build_forward(deploy_ckpt, max_batch, device)
    batcher = MicroBatcher(forward, max_batch=max_batch, window_ms=window_ms)
    stats = _Stats()
    srv_meta = dict(meta or {})

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: D102 (quiet: the CLI logs)
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, code: int, obj):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def _fail(self, code: int, message: str):
            stats.bump(False)
            self._reply_json(code, {"error": message})

        def do_GET(self):  # noqa: N802 (stdlib API)
            from urllib.parse import urlsplit

            path = urlsplit(self.path).path
            if path == "/healthz":
                self._reply_json(200, {"status": "ok", **srv_meta})
            elif path == "/stats":
                self._reply_json(200, stats.snapshot())
            else:
                self._reply_json(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            from urllib.parse import parse_qs, urlsplit

            url = urlsplit(self.path)
            if url.path != "/predict":
                self._reply_json(404, {"error": "unknown path"})
                return
            try:
                import cv2

                from fenet_torch.utils.images import normalize_rgb

                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
                if bgr is not None:
                    img = normalize_rgb(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
                    cloud = batcher.submit(img.astype(np.uint8)).result(timeout=120.0)
            except Exception as e:  # the server keeps running; the client learns why
                self._fail(500, str(e)[:300])
                return
            if bgr is None:
                self._fail(400, "undecodable image")
                return
            if parse_qs(url.query).get("format", ["json"])[0] == "ply":
                from fenet_torch.utils.ply import binary_ply

                body, ctype = binary_ply(cloud), "application/octet-stream"
            else:
                body, ctype = json.dumps({"points": cloud.tolist()}).encode(), "application/json"
            stats.bump(True)  # before the reply: see the module docstring
            self._reply(200, body, ctype)

    server = _Server((host, port), Handler)
    server.batcher = batcher
    server.stats = stats
    server.meta = srv_meta
    return server
