"""A copy of the benchmark's layout with tiny cells for the CPU tests: the
RepVGG-TEST backbone, fine width 32, mid width 16, 256 points, batches of
4, and the traffic kinds, metrics and reference of the real benchmark."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent.parent  # portbench/
ROOT = HERE.parent

TINY_CONFIG = {
    "source": "test fixture", "reference": "generator", "backbone": "RepVGG-TEST",
    "num_blocks": [1, 1, 1, 1], "width_multiplier": [0.25, 0.25, 0.25, 0.25], "num_classes": 1000,
    "edge_channels": [16, 3], "image_hw": 128, "num_points": 256, "fine_width": 32,
    "mid_width": 16, "assumed": {"head_scale": 0.03},
}
# The entries in BENCHMARK.json of the cells that wait for a later
# benchmark PR (PERF.md section 7), and their metrics: their workload
# files, traffic kinds and readers are in the benchmark's folder.
LATER = {
    "workloads": [
        {"name": "eval_a2_1024", "config": "a2_1024", "traffic": "eval_icp", "chips": 1,
         "why": "forward, ICP, auction EMD and chamfer at batch 64, 1024 points"},
        {"name": "serve_a2_1024", "config": "a2_1024", "traffic": "serve_open", "chips": 1,
         "why": "the bf16 fold behind the HTTP server, open-loop arrivals at 100/s"},
    ],
    "end_to_end": [
        {"name": "eval_samples_per_s", "unit": "samples/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["eval_a2_1024"]},
        {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["serve_a2_1024"]},
    ],
    "per_layer": [
        {"name": f"{metric}.{use}", "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": moves, "workloads": [cell]}
        for metric, use, unit, better, source, layer, moves, cell in [
            ("mfu", "eval", "%", "higher", "device_trace", "Step", "eval_samples_per_s",
             "eval_a2_1024"),
            ("idle_share", "eval", "%", "lower", "device_trace", "Device", "eval_samples_per_s",
             "eval_a2_1024"),
            ("icp_ms", "eval", "ms", "lower", "program_span", "Alignment", "eval_samples_per_s",
             "eval_a2_1024"),
            ("mfu", "serve", "%", "higher", "device_trace", "Step", "serve_p95_ms",
             "serve_a2_1024"),
            ("idle_share", "serve", "%", "lower", "device_trace", "Device", "serve_p95_ms",
             "serve_a2_1024"),
        ]
    ],
}
# Each tiny cell: the real cell it shrinks, and what it changes.
TINY_CELLS = {
    "tiny_train": ("train_a2_1024", {"batch": 4, "pool": 5, "trace_steps": 2,
                                     "reference_rows": 4, "emd_iters": 200}),
    "tiny_sinkhorn": ("train_a2_2048_sinkhorn", {"batch": 4, "pool": 5, "trace_steps": 2,
                                                 "reference_rows": 2, "sinkhorn_iters": 30}),
    "tiny_eval": ("eval_a2_1024", {"batch": 4, "pool": 3, "trace_batches": 2,
                                   "check_batches": 2, "warmup_batches": 1}),
    "tiny_serve": ("serve_a2_1024", {"max_batch": 4, "rate": 20.0, "images": 16,
                                     "check_requests": 8, "client_threads": 8,
                                     "warmup_requests": 8, "warmup_threads": 4,
                                     "trace_seconds": 1.0}),
}


def layout(tmp: Path) -> tuple:
    """(base, root): a copy of portbench/ under ``tmp`` with the tiny
    configuration and cells added, and a BENCHMARK.json beside it that
    lists the real cells, those kept for later (``LATER``) and the tiny
    ones."""
    base = tmp / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (base / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] += json.loads(json.dumps(LATER[key]))
    for name, (real, params) in TINY_CELLS.items():
        cell = json.loads((HERE / "workloads" / f"{real}.json").read_text())
        cell = dict(cell, params=dict(cell["params"], **params))
        (base / "workloads" / f"{name}.json").write_text(json.dumps(cell))
        entry = next(w for w in bench["workloads"] if w["name"] == real)
        bench["workloads"].append(dict(entry, name=name, config="tiny"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return base, tmp


def run(tmp: Path, cell: str, trace: bool = False, seed: int = 2 ** 31 + 7,
        seconds: float = 0.5, base: Optional[Path] = None):
    """One CPU run of a tiny cell: (result line, checks). ``base`` is a
    layout already made under ``tmp``; without it, one is made."""
    import time

    import torch

    from portbench import harness

    if base is None:
        base, _ = layout(tmp)
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.time(),
                            base=base)
