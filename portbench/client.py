"""The serving cell's load generator, run as a process of its own so that
its threads never take the server's interpreter lock.

    python3 portbench/client.py <spec.json>

The spec names the URL, the seed, the image pool, the arrival rate and the
window's length, the requests whose clouds to keep, and where to write the
results. The client POSTs ``warmup`` requests in a closed loop, prints
``READY``, waits for a line on standard input, then sends an open loop:
request k at its due time t_k, each from a PNG of the seeded pool. The
gaps between due times are the exponential distribution's quantiles at
the rate, shuffled by the seed, so every seed offers the same arrivals in
another order. A request's latency runs from its due time to the end of
its reply. When every request has its reply (or has failed) the client
writes ``<out>`` (.npz: latency, lateness, ok, kept indices and clouds)
and prints ``DONE``.
"""

from __future__ import annotations

import json
import math
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import inputs  # noqa: E402

REPLY_TIMEOUT_S = 60.0


def schedule(seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times (s from the window's opening) of round(rate * seconds)
    requests."""
    count = max(1, round(rate * seconds))
    gaps = -np.log1p(-(np.arange(count) + 0.5) / count) / rate
    gaps = gaps[inputs.permutation(seed, count)]
    return np.concatenate([[0.0], np.cumsum(gaps[:-1])])


def kept(seed: int, count: int, keep: int) -> np.ndarray:
    """The requests whose clouds are compared: ``keep`` drawn from the seed."""
    return np.sort(inputs.permutation(seed, count, inputs.KEEP)[:keep])


def bodies(seed: int, pool: int, hw: int):
    imgs = inputs.images(seed, pool, hw, "cpu").numpy()
    return [inputs.png(img) for img in imgs]


def post(url: str, body: bytes) -> np.ndarray:
    req = urllib.request.Request(url, data=body, headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req, timeout=REPLY_TIMEOUT_S) as reply:
        return np.asarray(json.load(reply)["points"], np.float32)


def run(spec: dict) -> None:
    url, n_points = spec["url"], spec["num_points"]
    pngs = bodies(spec["seed"], spec["pool"], spec["image_hw"])
    warm = iter(range(spec["warmup"]))
    lock = threading.Lock()

    def warm_up():
        while True:
            with lock:
                k = next(warm, None)
            if k is None:
                return
            post(url, pngs[k % len(pngs)])

    threads = [threading.Thread(target=warm_up) for _ in range(spec["warmup_threads"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    due = schedule(spec["seed"], spec["rate"], spec["seconds"])
    keep = kept(spec["seed"], len(due), spec["keep"])
    keep_at = {int(k): i for i, k in enumerate(keep)}
    latency = np.full(len(due), math.inf)
    late = np.zeros(len(due))
    ok = np.zeros(len(due), bool)
    clouds = np.full((len(keep), n_points, 3), np.nan, np.float32)
    errors = []
    cursor = iter(range(len(due)))
    print("READY", flush=True)
    if not sys.stdin.readline():  # the benchmark is gone: send nothing
        return
    t0 = time.perf_counter()

    def send():
        while True:
            with lock:
                k = next(cursor, None)
            if k is None:
                return
            wait = t0 + due[k] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late[k] = time.perf_counter() - t0 - due[k]
            try:
                cloud = post(url, pngs[k % len(pngs)])
            except Exception as e:  # a failed request is counted, never retried
                with lock:
                    errors.append(f"request {k}: {e!r}"[:200])
                continue
            latency[k] = time.perf_counter() - t0 - due[k]
            ok[k] = cloud.shape == (n_points, 3) and bool(np.isfinite(cloud).all())
            if k in keep_at:
                clouds[keep_at[k]] = cloud if ok[k] else np.nan

    threads = [threading.Thread(target=send) for _ in range(spec["threads"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    np.savez(spec["out"], latency=latency, late=late, ok=ok, keep=keep, clouds=clouds,
             window_s=time.perf_counter() - t0)
    for line in errors[:5]:
        print(line, file=sys.stderr)
    print("DONE", flush=True)


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        run(json.load(f))
