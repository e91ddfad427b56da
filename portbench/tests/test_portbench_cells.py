"""Whole runs of the tiny cells on the CPU (``tiny.py``): the harness minus
its look for a card. Sound runs come out ``correct``; runs with the timed
path broken underneath, once for each fault a cell can have, come out not
``correct``; and the controls, the reference put in the program's place in
the next precision below the configuration's, fail the real cells' limits."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.tests import tiny  # noqa: E402

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_sinkhorn", "tiny_eval", "tiny_serve"])
def test_a_sound_run_is_correct(tmp_path, cell):
    result, checks = tiny.run(tmp_path, cell)
    assert result["correct"], result["checks"]
    assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
    assert "setup_s" in result["metrics"] and len(result["metrics"]) == 2
    assert result["failed"] == 0 and result["attempted"] > 0
    json.dumps(result, allow_nan=False)


@pytest.mark.parametrize("cell", ["tiny_eval", "tiny_serve", "tiny_sinkhorn"])
def test_a_traced_run_reports_its_layers(tmp_path, cell):
    result, _ = tiny.run(tmp_path, cell, trace=True)
    assert result["correct"]
    assert {"busy_s", "window_s"} <= set(result["device"]) and result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert any(name.startswith("mfu.") for name in result["metrics"])


def _patch_train_step(monkeypatch, wrap):
    from fenet_torch.train import trainer

    original = trainer.Trainer.train_step
    monkeypatch.setattr(trainer.Trainer, "train_step",
                        lambda self, images, points, epoch, lr: wrap(original, self, images,
                                                                     points, epoch, lr))


def test_a_step_that_leaves_the_state_unchanged_is_caught(tmp_path, monkeypatch):
    def unchanged(original, self, images, points, epoch, lr):
        step = self.optimizer.step
        self.optimizer.step = lambda *a, **k: None
        try:
            return original(self, images, points, epoch, lr)
        finally:
            self.optimizer.step = step

    _patch_train_step(monkeypatch, unchanged)
    result, _ = tiny.run(tmp_path, "tiny_train")
    assert not result["correct"] and result["checks"]["change3_leaf"]["value"] == 1.0


def test_half_the_batch_left_out_is_caught(tmp_path, monkeypatch):
    def half(original, self, images, points, epoch, lr):
        keep = len(images) // 2
        return original(self, images[:keep], points[:keep], epoch, lr)

    _patch_train_step(monkeypatch, half)
    result, _ = tiny.run(tmp_path, "tiny_train")
    assert not result["correct"]


def test_a_program_that_computes_in_tf32_is_caught(tmp_path, monkeypatch):
    """The configuration states float32 with TF32 off: a trainer that turns
    TF32 on comes out not correct, while the reference still computes with
    every TF32 switch off, and the program's switches are left as it set
    them."""
    from fenet_torch.train import trainer
    from portbench import harness
    from portbench.reference.precision import tf32_switches

    def tf32():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    base, _ = tiny.layout(tmp_path)
    ref = harness.reference_module(harness.load_config("tiny", base), base)  # the run's own
    seen = []
    forward = ref.forward

    def watched(*args, **kwargs):
        seen.append(sum(tf32_switches().values()))
        return forward(*args, **kwargs)

    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    monkeypatch.setattr(trainer, "full_fp32", tf32)
    monkeypatch.setattr(ref, "forward", watched)
    try:
        result, _ = tiny.run(tmp_path, "tiny_train", base=base)
        after = sum(tf32_switches().values())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])
    assert not result["correct"] and result["checks"]["tf32_switches"]["value"] == 3.0
    assert seen and set(seen) == {0} and after == 3


def test_an_altered_eval_answer_is_caught(tmp_path, monkeypatch):
    from fenet_torch.eval import runner

    make = runner.make_eval_step

    def altered(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(images, points):
            out = step(images, points)
            out["cd"] = out["cd"] * torch.tensor([1.1] + [1.0] * (len(out["cd"]) - 1))
            return out
        return run

    monkeypatch.setattr(runner, "make_eval_step", altered)
    result, _ = tiny.run(tmp_path, "tiny_eval")
    assert not result["correct"] and result["checks"]["cd_sample"]["value"] > 0.09


def test_an_altered_served_cloud_is_caught(tmp_path, monkeypatch):
    from fenet_torch.serve import batcher

    fetch = batcher.fetch

    def altered(out):
        clouds = fetch(out).copy()
        clouds[:, 0, 0] += 0.2
        return clouds

    monkeypatch.setattr(batcher, "fetch", altered)
    result, _ = tiny.run(tmp_path, "tiny_serve")
    assert not result["correct"]


@pytest.mark.parametrize("cell", ["tiny_train", "tiny_eval", "tiny_serve"])
def test_the_control_is_not_correct(tmp_path, cell):
    """The reference in the cell's control precision (TF32 operands for
    float32, fp8 for the bfloat16 fold), put in the program's place, fails
    one of the cell's numbers at the real cell's limits."""
    import time

    from portbench import harness
    from portbench.reference.precision import Operands

    base, _ = tiny.layout(tmp_path)
    spec = harness.load_cell(cell, base)
    kind = harness.traffic(spec["kind"], base)
    ctx = harness.Context(spec, harness.load_config(spec["config"], base), 5, 0.3, False,
                          torch.device("cpu"), harness.load_json(base / "peaks.json"), base)
    state = kind.setup(ctx)
    win = kind.window(ctx, state)
    assert time.time() >= win.opened
    kind.program_outputs(ctx, state)
    want = kind.reference_outputs(ctx, state)
    control = kind.reference_outputs(ctx, state, Operands(spec["params"]["control"]))
    assert not all(c.ok for c in kind.compare(ctx, control, want))
    assert all(c.ok for c in kind.compare(ctx, want, want))
