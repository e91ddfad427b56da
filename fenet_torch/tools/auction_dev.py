"""Build, check, count and time the auction EMD kernels alone, on one CUDA card.

    python -m fenet_torch.tools.auction_dev [--source LABEL=PATH ...] [--case TEXT ...]

Builds ``fenet_torch/csrc/emd_auction.cu`` (label ``new``) and every
``--source`` (another file with the same two C entry points, such as an
earlier commit's unpacked under ``build/``; since the kernel counts its work
they take the (B, 2) work buffer after ``ass``, which a source from before
the counter must be given by hand), one ``nvcc`` each, all at once,
with the flags of ``fenet_torch.ops._build``, and prints each build's
``ptxas`` lines, and holds each build's square root against
``__fsqrt_rn(max(d, 0))`` on all 2^32 float bit patterns
(``emd.root_mismatches``; a build without ``fenet_emd_root_check`` is
skipped). Then, on each case below (or on those whose name contains
one of the ``--case`` texts), it runs the plain auction
(``_auction_loop(..., trace=True)``) and holds every library against it bit
for bit; on the eval batches, whose cross terms cuBLAS may round otherwise
than the kernels, it holds the EMD metric to 1e-2 and reports whether the
bits agree, with the plain version and with the first library. It times
each library with CUDA events in the order A B ... B A, with the SM clock
and power sampled meanwhile, and, for a batch, also the batch's slowest
element run alone (B = 1). The cases:

- ``chip_smoke.py``'s train clouds: the batch-128 synthetic batch through the
  full-width RepVGG-A2 generator at its unscaled init, in train mode, as
  the first counted step of ``phase_train`` hands them to its loss (after
  one warm-up step and its Adam update, in the same EMD mode): at 1024
  points (K3 at 0.05 / 3000; K5 with 3 phases and the gate at 0.3) and at
  2048 (K4 in both modes, the scaled one on the first 32 clouds);
- the eval batches at 1024 and 2048 points (K3, K4 at 0.005 / 50): the first
  batch of 64 through the generator with its heads scaled by 0.03, aligned
  by ICP to the gt;
- ``chip_smoke.py``'s STREAM_CASES on the same dyadic clouds, at the train
  setting and with the gate open; at N = 8192, B = 1 the latter is the lone
  element whose price war runs on one SM.

Each case prints one JSON line: per library the ms of each turn, the slowest
element's ms alone, the checks; per element the iterations of each phase,
the row bids and the bidders per iteration as a histogram (1, 2-4, 5-32,
33-1024, > 1024), summarised over the batch on the printed line and in full
in ``chiprun_out/auction_dev.jsonl``. A check that fails is reported
(``ok: false``) and makes the exit code 1 after all cases ran.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch

from fenet_torch.ops import _build, emd
from fenet_torch.tools.devkit import Emitter, build, card, clocks, event_ms, sampler, sources

MODEL = dict(backbone="RepVGG-A2", fine_width=512, mid_width=128)
HEAD_SCALE = 0.03  # chip_smoke.py's eval init
N_POINTS, WIDE_POINTS = 1024, 2048
TRAIN_BATCH, EVAL_BATCH = 128, 64
# The scaled mode at WIDE_POINTS runs on the first clouds only, as
# chip_smoke.py checks K4 (the plain version's time).
WIDE_SCALED_CHECK = 32
# chip_smoke.py's STREAM_CASES (N, B), drawn in its order from RandomState(3).
STREAM_CASES = ((2048, 4), (4096, 2), (8192, 1), (1100, 4), (5000, 1))
TRAIN = (0.05, 3000, 1, True, 0.0)
SCALED = (0.05, 3000, 3, True, 0.3)
EVAL = (0.005, 50, 1, True, 0.0)
SHARED_KEYS_MAX_N = emd.SHARED_KEYS_MAX_N
# Bidders per iteration: the histogram's bins, by their upper ends.
BINS = ((1, "1"), (4, "2-4"), (32, "5-32"), (1024, "33-1024"), (None, ">1024"))


def run(label, lib, x1, x2, settings):
    """The package's wrapper on library ``lib``. A ``--source`` build gets
    the (B, N) key buffer at every streaming N: an earlier source may keep
    all its keys there."""
    _build._loaded["emd_auction"] = lib
    emd.SHARED_KEYS_MAX_N = SHARED_KEYS_MAX_N if label == "new" else 0
    return emd.auction_kernel(x1, x2, *settings)


def make_model(device, n, head_scale):
    from fenet_torch.models.generator import Generator, init_random_
    from fenet_torch.utils.device import full_fp32

    full_fp32()
    with torch.device(device):
        gen = Generator(num_points=n, **MODEL)
    init_random_(gen, torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        for layer in (gen.fc3_1, gen.conv2_1, gen.conv1_3):
            layer.weight.mul_(head_scale)
            layer.bias.mul_(head_scale)
    return gen


def train_clouds(n, device):
    """{mode: (pred, gt)}: the clouds of the first counted train step in
    the default (``auction``) and eps-scaling (``scaled``) modes."""
    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer, reference_lr_schedule

    gen = make_model(device, n, 1.0)
    init_state = {k: v.clone() for k, v in gen.state_dict().items()}
    ds = SyntheticShapeNet(n_models=6, num_points=n, variety=True, seed=0)
    batch = next(iter(DataLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, seed=0)))
    images, points = batch["image"].astype(np.uint8), batch["points"]
    lr = reference_lr_schedule(5e-4, 1)
    out = {}
    for mode, overrides in (("auction", {}),
                            ("scaled", {"emd_scale_phases": 3, "emd_scale_thresh": 0.3})):
        gen.load_state_dict(init_state)
        trainer = Trainer(gen, TrainConfig(batch_size=TRAIN_BATCH, **overrides), device=device)
        seen, loss = [], trainer.emd

        def recording(pred, gt, seen=seen, loss=loss):
            seen.append((pred.detach().contiguous(), gt.detach().contiguous()))
            return loss(pred, gt)

        trainer.emd = recording
        for _ in range(2):  # the warm-up step, then the first counted one
            trainer.train_step(images, points, 1, lr)
        out[mode] = seen[1]
        del trainer
    del gen
    torch.cuda.empty_cache()
    return out


def eval_clouds(n, device):
    """(aligned pred, gt) of the first eval batch."""
    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.geometry.icp import align_pred_to_gt

    gen = make_model(device, n, HEAD_SCALE).to(device).eval()
    first = next(iter(DataLoader(SyntheticShapeNet(n_models=6, num_points=n, seed=0), EVAL_BATCH)))
    images = torch.as_tensor(first["image"]).to(device)
    points = torch.as_tensor(first["points"]).to(device)
    with torch.inference_mode():
        aligned = align_pred_to_gt(gen(images)[2], points)
    del gen
    torch.cuda.empty_cache()
    return aligned.clone().contiguous(), points.clone().contiguous()


def stream_clouds(device):
    """{(n, b): (x1, clustered x1, x2)}: chip_smoke.py's dyadic clouds."""
    rng = np.random.RandomState(3)
    out = {}
    for n, b in STREAM_CASES:
        x1, x2 = (torch.tensor(rng.randint(-64, 65, size=(b, n, 3)) / 64.0,
                               dtype=torch.float32, device=device) for _ in range(2))
        for _ in range(2):  # chip_smoke.py's normal clouds, drawn next
            rng.randn(b, n, 3)
        out[(n, b)] = (x1, torch.round(x1 * 4) / 256, x2)
    return out


def census(bidders):
    """Per element: iterations of each phase, bids, bidder histogram."""
    per_phase = [(t > 0).sum(0).tolist() for t in bidders]
    steps = torch.cat(bidders).cpu()
    hist, lo = {}, 0
    for hi, label in BINS:
        inside = steps > lo if hi is None else (steps > lo) & (steps <= hi)
        hist[label] = inside.sum(0).tolist()
        lo = hi
    return {"iterations": per_phase, "bid_rows": steps.sum(0).tolist(), "bidders": hist}


def spread(values):
    v = sorted(values)
    return {"min": v[0], "median": v[len(v) // 2], "max": v[-1]}


def cases(device):
    """(name, make, settings, exact) in order; ``make`` builds (x1, x2)."""
    train = {}

    def train_case(n, mode, first=None):
        def make():
            if n not in train:
                train.clear()
                train[n] = train_clouds(n, device)
            x1, x2 = train[n][mode]
            return (x1, x2) if first is None else (x1[:first].contiguous(), x2[:first].contiguous())
        return make

    stream = {}

    def stream_case(n, b, clustered):
        def make():
            if not stream:
                stream.update(stream_clouds(device))
            x1, x1c, x2 = stream[(n, b)]
            return (x1c if clustered else x1), x2
        return make

    n, wide = N_POINTS, WIDE_POINTS
    out = [(f"train N={n} auction (K3)", train_case(n, "auction"), TRAIN, True),
           (f"train N={n} scaled (K5)", train_case(n, "scaled"), SCALED, True),
           (f"train N={wide} auction (K4)", train_case(wide, "auction"), TRAIN, True),
           (f"train N={wide} scaled, first {WIDE_SCALED_CHECK} (K4)",
            train_case(wide, "scaled", WIDE_SCALED_CHECK), SCALED, True),
           (f"eval N={n} (K3)", lambda: eval_clouds(N_POINTS, device), EVAL, False),
           (f"eval N={wide} (K4)", lambda: eval_clouds(WIDE_POINTS, device), EVAL, False)]
    for n, b in STREAM_CASES:
        out.append((f"stream N={n} B={b} train", stream_case(n, b, False), TRAIN, True))
        lone = " (the lone element)" if (n, b) == (8192, 1) else ""
        out.append((f"stream N={n} B={b} gate open{lone}", stream_case(n, b, True), SCALED, True))
    return out


def check(got, want, first, exact):
    """Bit-exact, or (eval) the EMD metric to 1e-2; also whether the bits
    equal the plain version's and the first library's."""
    d_k, a_k = got
    d_p, a_p = want
    same = torch.equal(d_k, d_p) and torch.equal(a_k, a_p)
    m_k, m_p = float(d_k.sqrt().mean()), float(d_p.sqrt().mean())
    row = {"bit_exact": same, "max_abs_err": float((d_k - d_p).abs().max()),
           "metric_rel_err": abs(m_k - m_p) / m_p}
    if first is not None:
        row["same_as_first"] = torch.equal(d_k, first[0]) and torch.equal(a_k, first[1])
    row["ok"] = same if exact else row["metric_rel_err"] <= 1e-2
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH")
    ap.add_argument("--case", action="append", default=[], metavar="TEXT")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("auction_dev: needs a CUDA card", file=sys.stderr)
        return 1
    emit = Emitter("auction_dev.jsonl")
    device = torch.device("cuda", 0)
    emit({"device": card(), "torch": torch.__version__, "cuda": torch.version.cuda})
    t_start = time.perf_counter()
    loaded, failed = build(sources(args.source, "emd_auction"), "emd_auction", emit)
    emit({"build_s": time.perf_counter() - t_start, "failed": failed})
    order = list(loaded) + list(reversed(list(loaded)))

    bad = 0
    for label, lib in loaded.items():
        if hasattr(lib, "fenet_emd_root_check"):
            _build._loaded["emd_auction"] = lib
            t0 = time.perf_counter()
            mismatches, lowest = emd.root_mismatches(device)
            emit({"root_check": label, "mismatches": mismatches, "lowest": lowest,
                  "s": time.perf_counter() - t0})
            bad += mismatches != 0
    for name, make, settings, exact in cases(device):
        if args.case and not any(text in name for text in args.case):
            continue
        try:
            x1, x2 = make()
            t0 = time.perf_counter()
            d_p, a_p, _, bidders = emd._auction_loop(x1, x2, *settings, trace=True)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        except Exception:  # report the case and go on to the next
            emit({"case": name, "ok": False, "error": traceback.format_exc()})
            bad += 1
            continue
        counts = census(bidders)
        b = x1.shape[0]
        total_iters = [sum(p[e] for p in counts["iterations"]) for e in range(b)]
        slowest = max(range(b), key=lambda e: (total_iters[e], counts["bid_rows"][e]))
        per, first = {}, None
        for label, lib in loaded.items():
            t0 = time.perf_counter()
            got = run(label, lib, x1, x2, settings)
            torch.cuda.synchronize()
            r = per[label] = check(got, (d_p, a_p), first, exact)
            r["first_ms"] = (time.perf_counter() - t0) * 1e3
            first = first or got
            bad += not r["ok"]
        smi = sampler()
        for label in order:
            reps = max(1, min(10, int(500 / max(per[label]["first_ms"], 1e-3))))
            per[label].setdefault("ms", []).append(
                event_ms(lambda: run(label, loaded[label], x1, x2, settings), reps, warmup=0))
        sm_mhz_w = clocks(smi)
        if b > 1:
            one = (x1[slowest:slowest + 1].contiguous(), x2[slowest:slowest + 1].contiguous())
            for label in loaded:
                per[label]["slowest_alone_ms"] = event_ms(
                    lambda: run(label, loaded[label], *one, settings), 1)
        summary = {
            "case": name, "B": b, "N": x1.shape[1], "settings": settings,
            "plain_ms": plain_ms, "sm_mhz_w": sm_mhz_w, "libs": per,
            "iterations": spread(total_iters), "bid_rows": spread(counts["bid_rows"]),
            "bidders_sum": {k: sum(v) for k, v in counts["bidders"].items()},
            "slowest": {"element": slowest,
                        "iterations": [p[slowest] for p in counts["iterations"]],
                        "bid_rows": counts["bid_rows"][slowest],
                        "bidders": {k: v[slowest] for k, v in counts["bidders"].items()}},
        }
        emit(summary)
        emit({"case": name, "per_element": counts}, echo=False)
        del x1, x2, d_p, a_p, bidders, first
        torch.cuda.empty_cache()
    emit({"done": True, "failed_checks": bad, "failed_builds": failed,
          "seconds": time.perf_counter() - t_start})
    return 1 if bad or failed else 0


if __name__ == "__main__":
    sys.exit(main())
