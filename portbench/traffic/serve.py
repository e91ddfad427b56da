"""Serving traffic: the port's HTTP server (``make_server``: the
MicroBatcher at the mix's ``max_batch`` and ``window_ms``) on the
bfloat16 deploy fold of the benchmark's seeded weights, written under
TMPDIR as the ``export_deploy --format torch`` CLI writes it, driven by an
open loop of single-image PNG requests at the mix's fixed rate from a
client process of its own (``portbench/client.py``).

The weights carry seeded BatchNorm statistics, so that the fold is not the
identity, and the decoder's output layers are scaled by the
configuration's ``head_scale``. After the window, the clouds of a sample of
the requests, drawn from the seed, are held against the reference's own
float32 fold of the same weights.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from portbench import inputs, tracing
from portbench.harness import HERE, Check, Window
from portbench.reference.precision import Operands, exact_float32


def weights(ctx) -> dict:
    return ctx.reference.init(ctx.config, inputs.stream_seed(ctx.seed, inputs.WEIGHTS),
                              ctx.device, head_scale=ctx.config["assumed"]["head_scale"],
                              random_bn=True)


def write_fold(ctx, state0: dict) -> str:
    """The bfloat16 fold as ``export_deploy --format torch`` writes it: the
    folded state_dict and its JSON sidecar, under TMPDIR."""
    from fenet_torch.models.generator import Generator, to_deploy

    cfg = ctx.config
    arch = {k: cfg[k] for k in ("num_points", "backbone", "fine_width", "mid_width")}
    with torch.device(ctx.device):
        gen = Generator(**arch)
    gen.load_state_dict(state0, strict=True)
    deploy = to_deploy(gen, torch.bfloat16)
    path = os.path.join(ctx.tmp, "model_deploy.pth")
    torch.save({k: v.cpu() for k, v in deploy.state_dict().items()}, path)
    with open(path + ".json", "w") as f:
        json.dump({"deploy": True, **arch, "dtype": "bfloat16"}, f)
    return path


def start_client(ctx, state, rate: float, seconds: float, warmup: int) -> subprocess.Popen:
    """A client process that has sent its warm-up and waits for the word;
    it writes its results to ``proc.out``."""
    p, cfg = ctx.params, ctx.config
    out = os.path.join(ctx.tmp, "client.npz")
    spec = {"url": f"http://127.0.0.1:{state['server'].server_address[1]}/predict",
            "seed": ctx.seed, "pool": p["images"], "image_hw": cfg["image_hw"],
            "num_points": cfg["num_points"], "rate": rate, "seconds": seconds,
            "keep": p["check_requests"], "threads": p["client_threads"],
            "warmup": warmup, "warmup_threads": p["warmup_threads"], "out": out}
    path = os.path.join(ctx.tmp, "client.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    proc = subprocess.Popen([sys.executable, str(HERE / "client.py"), path],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    if proc.stdout.readline().strip() != "READY":
        proc.kill()
        proc.wait()
        raise RuntimeError("the client did not get ready")
    proc.out = out
    return proc


def finish_client(proc: subprocess.Popen, timeout: float):
    """Start the client's window, wait for it to end; its results."""
    proc.stdin.write("GO\n")
    proc.stdin.flush()
    try:
        line = proc.stdout.readline().strip()
        proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if line != "DONE":
        raise RuntimeError(f"the client ended with {line!r}, exit {proc.returncode}")
    with np.load(proc.out) as z:
        return {k: z[k] for k in z.files}


def setup(ctx) -> dict:
    from fenet_torch.serve.server import make_server

    p = ctx.params
    state0 = weights(ctx)
    path = write_fold(ctx, state0)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    server = make_server(path, host="127.0.0.1", port=0, max_batch=p["max_batch"],
                         window_ms=p["window_ms"], device=str(ctx.device))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    state = {"state0": state0, "server": server, "thread": thread}
    seconds = p["trace_seconds"] if ctx.trace else ctx.seconds
    state["client"] = start_client(ctx, state, p["rate"], seconds, p["warmup_requests"])
    return state


def stop_server(state) -> None:
    server = state.pop("server", None)
    if server is not None:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        state.pop("thread").join(timeout=30)


def window(ctx, state) -> Window:
    dev, proc = ctx.device, state["client"]
    seconds = ctx.params["trace_seconds"] if ctx.trace else ctx.seconds
    timeout = seconds + 120.0
    opened, t0 = time.time(), time.perf_counter()
    if ctx.trace:
        with tracing.traced(ctx.tmp, dev) as held:
            res = finish_client(proc, timeout)
    else:
        res = finish_client(proc, timeout)
    state["result"] = res
    done = int(res["ok"].sum())
    return Window(opened, time.perf_counter() - t0, done, len(res["ok"]),
                  len(res["ok"]) - done, held["trace"] if ctx.trace else None)


def end_to_end(ctx, state, win: Window) -> dict:
    latency = np.minimum(state["result"]["latency"], 1e9)  # a failed request: never answered
    return {"serve_p95_ms": float(np.percentile(latency, 95)) * 1e3}


def reference_clouds(ctx, state0: dict, requests, ops: Operands = Operands()) -> torch.Tensor:
    """The reference's clouds for the given request numbers, from its own
    float32 fold."""
    imgs = inputs.images(ctx.seed, ctx.params["images"], ctx.config["image_hw"], "cpu")
    pick = imgs[torch.as_tensor(np.asarray(requests) % len(imgs))].to(ctx.device)
    ref = ctx.reference
    folded = ref.fold(state0, ctx.config)
    return torch.cat([ref.deploy_forward(folded, pick[i:i + 32], ctx.config, ops)
                      for i in range(0, len(pick), 32)])


def compare(ctx, got: torch.Tensor, want: torch.Tensor):
    """The worst request's largest coordinate gap over its reference
    cloud's largest coordinate."""
    got = got.to(want.device, torch.float32)
    gap = ((got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2))).max()
    return [Check("cloud", float(gap), ctx.limits["cloud"])]


def program_outputs(ctx, state) -> torch.Tensor:
    """The served clouds of the sampled requests; the server stopped."""
    stop_server(state)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return torch.as_tensor(state["result"]["clouds"])


def reference_outputs(ctx, state, ops: Operands = Operands()) -> torch.Tensor:
    with exact_float32():
        return reference_clouds(ctx, state["state0"], state["result"]["keep"], ops)


def check(ctx, state, win: Window):
    got = program_outputs(ctx, state)
    return compare(ctx, got, reference_outputs(ctx, state))
