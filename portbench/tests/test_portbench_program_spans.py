"""The readers of what the program records itself: its spans on the
profiler's timeline (``fenet_torch.*``, from ``fenet_torch.utils.profiling
.span``) and the auction's count of its work (``fenet_torch.ops.emd
.auction_work``).

The program's spans map to no layer (no prefix of ``layers.json`` matches
them), so a trace that holds them gives every existing metric the value it
gives without them, and the breakdown's idle gaps take the program's
innermost span; the optimizer's metric reads torch's ``Optimizer.step``
range; the auction's counts come from the program, and from a program
without the counter they read nothing."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness, tracing  # noqa: E402
from portbench.tests import tiny  # noqa: E402

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
EXISTING = ["mfu.train", "idle_share.train", "forward_ms.train", "backward_ms.train",
            "loss_ms.train", "sinkhorn_roofline"]
MAIN, AUTOGRAD, STREAM = 1, 2, 7
# Per step: the spans (name, start, end, thread, category) and the launches
# (host time, thread, kernel, device start, duration), in µs from the step's
# start, as a Sinkhorn train step records them; the program's spans last.
BENCH_SPANS = [
    ("portbench.step", 0, 470, MAIN, "user_annotation"),
    ("portbench.model", 10, 110, MAIN, "user_annotation"),
    ("portbench.loss", 120, 270, MAIN, "user_annotation"),
    ("portbench.potentials", 150, 200, MAIN, "user_annotation"),
    ("autograd::engine::evaluate_function: ConvolutionBackward0", 280, 380, AUTOGRAD, "cpu_op"),
    ("Optimizer.step#Adam.step", 400, 450, MAIN, "user_annotation"),
]
PROGRAM_SPANS = [
    ("fenet_torch.train.step", 1, 469, MAIN, "user_annotation"),
    ("fenet_torch.train.forward", 5, 115, MAIN, "user_annotation"),
    ("fenet_torch.model.backbone", 15, 105, MAIN, "user_annotation"),
    ("fenet_torch.train.loss", 116, 275, MAIN, "user_annotation"),
    ("fenet_torch.loss.chamfer", 125, 145, MAIN, "user_annotation"),
    ("fenet_torch.loss.emd", 146, 268, MAIN, "user_annotation"),
    ("fenet_torch.ops.potentials", 152, 198, MAIN, "user_annotation"),
    ("fenet_torch.sinkhorn.plan", 205, 265, MAIN, "user_annotation"),
    ("fenet_torch.train.backward", 276, 390, MAIN, "user_annotation"),
    ("fenet_torch.train.optimizer", 395, 455, MAIN, "user_annotation"),
]
LAUNCHES = [
    (20, MAIN, "conv_fprop", 30, 60),
    (130, MAIN, "chamfer_nn_kernel", 135, 10),
    (160, MAIN, "sinkhorn_kernel", 165, 30),
    (210, MAIN, "vectorized_elementwise_kernel", 215, 40),
    (290, AUTOGRAD, "dgrad_engine", 300, 70),
    (410, MAIN, "multi_tensor_apply_kernel", 420, 20),
]
STEPS, STEP_US, WINDOW_US = 2, 480, 1000


def _chrome_trace(path: Path, program: bool) -> None:
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 0.0,
               "dur": float(WINDOW_US), "pid": 0, "tid": MAIN}]
    for step in range(STEPS):
        t0 = 10 + step * STEP_US
        for name, start, end, tid, cat in BENCH_SPANS + (PROGRAM_SPANS if program else []):
            events.append({"ph": "X", "cat": cat, "name": name, "ts": float(t0 + start),
                           "dur": float(end - start), "pid": 0, "tid": tid})
        for k, (host, tid, kernel, start, dur) in enumerate(LAUNCHES):
            corr = step * len(LAUNCHES) + k + 1
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": float(t0 + host), "dur": 2.0, "pid": 0, "tid": tid,
                           "args": {"correlation": corr}})
            events.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": float(t0 + start),
                           "dur": float(dur), "pid": 1, "tid": STREAM,
                           "args": {"correlation": corr}})
    path.write_text(json.dumps({"traceEvents": events}))


def _ctx(cell: str = "train_a2_2048_sinkhorn"):
    spec = harness.load_cell(cell)
    return harness.Context(spec, harness.load_config(spec["config"]), 5, 1.0, True,
                           torch.device("cpu"), harness.load_json(harness.HERE / "peaks.json"))


def _window(trace) -> harness.Window:
    return harness.Window(0.0, 1.0, 128 * STEPS, STEPS, 0, trace, {"steps": STEPS})


def _reduced(tmp_path: Path, program: bool):
    path = tmp_path / f"trace_{int(program)}.json"
    _chrome_trace(path, program)
    return tracing.reduce_trace(str(path), WINDOW_US / 1e6)


def test_program_spans_move_no_existing_metric(tmp_path):
    """The same device operations and benchmark spans, with and without the
    program's spans: the same layers, the same six metrics and the same
    device breakdown; the idle gaps keep their total and take the
    program's innermost span."""
    bare, spanned = _reduced(tmp_path, False), _reduced(tmp_path, True)
    assert [(op.name, op.layers) for op in bare.ops] == \
        [(op.name, op.layers) for op in spanned.ops]
    ctx = _ctx()
    for name in EXISTING + ["optimizer_ms.train"]:
        metric = harness.reader(name)
        assert metric.read(ctx, _window(bare)) == metric.read(ctx, _window(spanned)), name
    layers = {op.name: op.layers for op in bare.ops}
    assert layers["conv_fprop"] == {"Step", "Model"}
    assert layers["sinkhorn_kernel"] == {"Step", "Losses", "Kernels"}
    assert layers["dgrad_engine"] == {"Model backward"}
    assert layers["multi_tensor_apply_kernel"] == {"Step", "Optimizer"}
    assert bare.breakdown()["device_ops"] == spanned.breakdown()["device_ops"]
    assert sum(bare.idle_by_host.values()) == pytest.approx(sum(spanned.idle_by_host.values()))
    # The host between the benchmark's model span and the backbone's (the
    # images' cast) stays the model span's; the rest moves to the program's.
    program = sum(v for k, v in spanned.idle_by_host.items()
                  if k.startswith(("fenet_torch.", "Optimizer.")))
    moved = sum(bare.idle_by_host[k] for k in ("portbench.step", "portbench.loss",
                                               "portbench.potentials"))
    assert program == pytest.approx(moved)
    assert set(spanned.idle_by_host) - {"host", "portbench.model"} == \
        {k for k in spanned.idle_by_host if k.startswith("fenet_torch.")}


def test_optimizer_ms_reads_the_adam_update_a_step(tmp_path):
    metric = harness.reader("optimizer_ms.train")
    assert metric.read(_ctx(), _window(_reduced(tmp_path, True))) == pytest.approx(20 / 1e3)
    ops = [tracing.DeviceOp("conv_fprop", 0.0, 60.0, frozenset({"Step", "Model"}))]
    assert metric.read(_ctx(), _window(tracing.Trace(1.0, ops, []))) is None
    assert metric.read(_ctx(), harness.Window(0.0, 1.0, 0, 0, 0, None, {"steps": 0})) is None


def test_auction_counts_read_the_programs_totals_a_step(monkeypatch):
    """The two counts divide the program's totals by the window's steps;
    the program counts only the calls made while a profiler records, and
    with none counted they read nothing, as from a program without the
    counter (the parent of the counter: the reader's import fails)."""
    from fenet_torch.ops import emd

    monkeypatch.setattr(emd.auction_work, "totals", {})
    monkeypatch.setattr(emd.auction_work, "calls", {})
    bids, iters = harness.reader("auction_bids.train"), harness.reader("auction_iters.train")
    ctx, win = _ctx("train_a2_1024"), _window(None)
    gen = torch.Generator().manual_seed(3)
    clouds = [(torch.rand(2, 64, 3, generator=gen), torch.rand(2, 64, 3, generator=gen))
              for _ in range(3)]
    emd.earth_mover_distance(*clouds[0], 0.05, 300)  # no profiler: not counted
    assert bids.read(ctx, win) is None and iters.read(ctx, win) is None
    per_call = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for x1, x2 in clouds:
            emd.earth_mover_distance(x1, x2, 0.05, 300)
    for x1, x2 in clouds:
        _, _, bid_rows, bidders = emd._auction_loop(x1, x2, 0.05, 300, trace=True)
        per_call.append((int(bid_rows.sum()), max(t.shape[0] for t in bidders)))
    assert bids.read(ctx, win) == pytest.approx(sum(b for b, _ in per_call) / STEPS)
    assert iters.read(ctx, win) == pytest.approx(sum(i for _, i in per_call) / STEPS)
    monkeypatch.delattr(emd, "auction_work")
    assert bids.read(ctx, win) is None and iters.read(ctx, win) is None


def test_a_traced_train_cell_reports_the_auction_counts(tmp_path, monkeypatch):
    """The tiny auction cell's traced run reports both counts, over the two
    traced steps alone: set-up's three steps, run with no profiler, are not
    counted. (No metric of the device trace reads anything on the CPU,
    which launches no kernel.)"""
    from fenet_torch.ops import emd

    monkeypatch.setattr(emd.auction_work, "totals", {})
    monkeypatch.setattr(emd.auction_work, "calls", {})
    result, _ = tiny.run(tmp_path, "tiny_train", trace=True)
    assert result["correct"]
    metrics = result["metrics"]
    assert emd.auction_work("cpu")["calls"] == 2
    assert metrics["auction_bids.train"]["unit"] == "bids/step"
    assert metrics["auction_bids.train"]["value"] >= 4 * 256  # every row bids once a call
    assert 1 <= metrics["auction_iters.train"]["value"] <= 200
    assert "optimizer_ms.train" not in metrics
    sinkhorn, _ = tiny.run(tmp_path / "sinkhorn", "tiny_sinkhorn", trace=True)
    assert not {"auction_bids.train", "auction_iters.train"} & set(sinkhorn["metrics"])
