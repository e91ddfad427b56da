"""The operation counts beside the benchmark: the generator's FLOPs from
the configuration's shapes against ``torch.utils.flop_counter`` on the port
(meta tensors: no memory, no arithmetic), and the Sinkhorn potentials' work
from shapes and iterations alone."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402
from portbench.counts import sinkhorn  # noqa: E402

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("name", ["a2_1024", "a2_2048"])
def test_generator_flops_match_the_flop_counter(name):
    from torch.utils.flop_counter import FlopCounterMode

    from fenet_torch.models.generator import Generator

    cfg = harness.load_config(name)
    counts = harness.count_module(cfg)
    arch = dict(num_points=cfg["num_points"], backbone=cfg["backbone"],
                fine_width=cfg["fine_width"], mid_width=cfg["mid_width"])
    with torch.device("meta"):
        gen, deploy = Generator(**arch), Generator(**arch, deploy=True)
        images = torch.zeros((1, cfg["image_hw"], cfg["image_hw"], 3))
        with FlopCounterMode(display=False) as forward:
            gen(images)
        with FlopCounterMode(display=False) as train:
            gen(images)[2].sum().backward()
        with FlopCounterMode(display=False) as folded:
            deploy(images)
    assert counts.forward_flops(cfg) == forward.get_total_flops()
    assert counts.train_flops(cfg) == train.get_total_flops()
    assert counts.deploy_flops(cfg) == folded.get_total_flops()
    assert round(counts.forward_flops(cfg) / 1e9, 2) == 4.22
    assert round(counts.train_flops(cfg) / 1e9, 2) in (12.64, 12.65)


def test_sinkhorn_work_follows_shapes_and_iterations_alone():
    assert sinkhorn.potentials_ops(128, 2048, 2048, 300) == 128 * 2048 * 2048 * 600 * 12
    assert sinkhorn.potentials_ops(2, 10, 20, 3) * 2 == sinkhorn.potentials_ops(2, 10, 20, 6)
    assert sinkhorn.potentials_bytes(128, 2048, 2048) == 128 * 4096 * 16
    # At the training shape the potentials are bound by operations, not bytes.
    least = sinkhorn.least_seconds(128, 2048, 2048, 300, 67e12, 3.35e12)
    assert least == pytest.approx(sinkhorn.potentials_ops(128, 2048, 2048, 300) / 67e12)
    assert 0.05 < least < 0.06


@pytest.mark.parametrize("launches", [1, 2, 300])
def test_the_sinkhorn_roofline_reads_the_same_however_a_solve_is_split(launches):
    """The share counts one solve a step from the traffic and takes the
    device time of everything launched inside the potentials' call: a
    solve split into more launches of the same total time reads the same."""
    from portbench import tracing

    metric = harness.reader("sinkhorn_roofline")
    steps, solve_us = 4, 190_000.0
    ops = [tracing.DeviceOp(f"part{k % 2}", 0.0, solve_us / launches,
                            frozenset({"Losses", "Kernels"}))
           for _ in range(steps) for k in range(launches)]
    ops.append(tracing.DeviceOp("sinkhorn_kernel", 0.0, 50_000.0, frozenset({"Losses"})))
    win = harness.Window(0.0, 1.0, 128 * steps, steps, 0,
                         tracing.Trace(1.0, ops, []), {"steps": steps})
    cfg = json.loads((CONFIGS / "a2_2048.json").read_text())
    ctx = type("Ctx", (), {"config": cfg, "peaks": json.loads(
        (CONFIGS.parent / "peaks.json").read_text()),
        "params": {"batch": 128, "sinkhorn_iters": 300}})()
    least = sinkhorn.least_seconds(128, 2048, 2048, 300, ctx.peaks["float32_flops_per_s"],
                                   ctx.peaks["hbm_bytes_per_s"])
    assert metric.read(ctx, win) == pytest.approx(100.0 * least / (solve_us / 1e6))
    empty = harness.Window(0.0, 1.0, 0, 0, 0, tracing.Trace(1.0, ops[-1:], []), {"steps": 1})
    assert metric.read(ctx, empty) is None
