"""Stdlib HTTP front end for a deploy checkpoint or artifact (counterpart of
``fenet/serve/server.py``): a ThreadingHTTPServer whose handlers enqueue
into one :class:`~fenet_torch.serve.batcher.MicroBatcher`, so concurrent
requests share padded device batches. Over several devices each holds a
replica and the batch is split into equal contiguous shards, one a device,
as fenet shards its batch over every local device.

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
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from fenet_torch.utils.device import full_fp32, resolve_device


def device_forward(replicas: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                   devices: Sequence) -> Callable:
    """``forward(images)`` for the MicroBatcher and the predict CLI over one
    or several devices: the (b, H, W, 3) uint8 numpy batch is split into
    ``len(devices)`` equal contiguous shards, shard i goes to ``devices[i]``
    as uint8 (the replica casts it there) and runs ``replicas[i]``. The
    results return still in flight: the lone tensor on one device, else the
    shards in order (:func:`fenet_torch.serve.batcher.fetch` concatenates
    them on the host).

    On a card the batch is staged in pinned memory and each shard copied
    with ``non_blocking`` under its own card's context (the launches would
    otherwise land on the current card), so the host waits on no device:
    that is what lets the batcher's depth-1 pipeline overlap an upload with
    the previous batch's compute. PyTorch's caching host allocator hands a
    pinned block out again only once the copy recorded on it has completed.
    ``inference_mode`` is thread-local, so the forward enters it itself, in
    whichever thread calls it.
    """
    devices = [torch.device(d) for d in devices]
    full_fp32()  # the float32 fold computes in IEEE float32, as the eval path
    n = len(devices)

    def forward(images: np.ndarray):
        if len(images) % n:
            raise ValueError(f"a batch of {len(images)} does not split over {n} devices")
        x = torch.from_numpy(np.ascontiguousarray(images, np.uint8))
        if any(d.type == "cuda" for d in devices):
            x = x.pin_memory()
        outs = []
        with torch.inference_mode():
            for replica, device, shard in zip(replicas, devices, x.split(len(x) // n)):
                if device.type == "cuda":
                    with torch.cuda.device(device):
                        outs.append(replica(shard.to(device, non_blocking=True)))
                else:
                    outs.append(replica(shard))
        return outs if n > 1 else outs[0]

    return forward


def serving_devices(device="cuda", devices=None) -> List[torch.device]:
    """The devices a forward serves over: ``devices`` when given (a device
    may repeat: two replicas on one card), else every visible card for a
    bare ``cuda``, else the one device ``device`` names (``cuda:1``,
    ``cpu``). A card that is not there raises."""
    if devices is not None:
        return [resolve_device(d) for d in devices]
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        resolve_device(device)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve_device(device)]


def round_batch(max_batch: int, n_devices: int) -> int:
    """``max_batch`` rounded up to a multiple of the device count, as fenet
    rounds its serving batch, so that every shard is equal."""
    return -(-int(max_batch) // n_devices) * n_devices


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def build_forward(deploy_ckpt: str, max_batch: int, device="cuda", devices=None):
    """(forward, meta): the deploy forward at the fixed serving batch over
    :func:`serving_devices` (every visible card for ``cuda``), from a folded
    checkpoint (``export_deploy --format torch``, or by its ``.ckpt``
    suffix fenet's ``model_deploy.ckpt`` and ``--format flax``) or, by its
    ``.pt2`` suffix, a frozen artifact (``--format export``). ``meta["max_batch"]``
    is ``max_batch`` rounded up to the device count, ``meta["devices"]``
    the count."""
    from fenet_torch.serve.artifact import ARTIFACT_SUFFIX, build_forward_artifact

    if deploy_ckpt.endswith(ARTIFACT_SUFFIX):
        return build_forward_artifact(deploy_ckpt, max_batch, device, devices)
    from fenet_torch.cli.export_deploy import load_deploy_checkpoint

    devices = serving_devices(device, devices)
    models = {d: load_deploy_checkpoint(deploy_ckpt, d) for d in dict.fromkeys(devices)}
    gen, dtype = next(iter(models.values()))
    meta = {"num_points": gen.num_points, "backbone": gen.backbone,
            "dtype": dtype_name(dtype), "max_batch": round_batch(max_batch, len(devices)),
            "devices": len(devices)}
    replicas = [lambda x, g=models[d][0]: g(x)[2] for d in devices]
    return device_forward(replicas, devices), meta


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
    they come from :func:`build_forward` on ``device``, and the batch is
    ``meta["max_batch"]``, rounded up to the device count."""
    from fenet_torch.serve.batcher import MicroBatcher

    if forward is None:
        forward, meta = build_forward(deploy_ckpt, max_batch, device)
        max_batch = meta["max_batch"]
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
