"""Build, check and time the Sinkhorn potentials kernel alone, on one CUDA card.

    python -m fenet_torch.tools.sinkhorn_dev [--source LABEL=PATH ...]

Builds ``fenet_torch/csrc/sinkhorn.cu`` (label ``new``) and every
``--source`` (another file with the same C interface ``fenet_sinkhorn``,
such as an earlier commit's unpacked under ``build/``), one ``nvcc`` each,
all at once, with the flags of ``fenet_torch.ops._build``, and prints each
build's ``ptxas`` lines. Then, on each case below, each library is held
against ``_potentials_plain`` at fenet's tolerance (rtol 1e-4, atol 1e-5)
and timed with CUDA events, the libraries in the order A B ... B A so that
drift on the card shows, with the SM clock and power sampled meanwhile:

- ``chip_smoke.py``'s SINKHORN_CASES (uniform clouds, N = M);
- the training shape B=128, N=M=1024 and 2048, 300 iterations, uniform;
- the training step's clouds: the batch-128 synthetic batch through the
  full-width RepVGG-A2 generator at its unscaled init (train mode), at 1024
  and 2048 points, with ``loss_rel_err``, the relative gap between the loss
  (``losses.sinkhorn.plan_loss``) from the library's potentials and from the
  plain ones;
- N = 5000, M = 4096 (several sweeps of rows), and x scaled x30 for 20
  iterations, held against the plain version run on the CPU (on the card
  PyTorch divides by a scalar as a product with its reciprocal, which at
  this scale leaves the tolerance by itself).

Each case prints one JSON line (also appended to
``chiprun_out/sinkhorn_dev.jsonl``); a check that fails is reported in its
line (``ok: false``) and makes the exit code 1 after all cases ran.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np
import torch

from fenet_torch.ops import _build, sinkhorn
from fenet_torch.tools.devkit import Emitter, build, card, clocks, event_ms, sampler, sources

RTOL, ATOL = 1e-4, 1e-5
EPS, EPS0 = 1e-4, 0.25
# chip_smoke.py's model: the train step's clouds come from it.
MODEL = dict(backbone="RepVGG-A2", fine_width=512, mid_width=128)


def run(lib, x, y, iters):
    _build._loaded["sinkhorn"] = lib
    return sinkhorn.potentials_kernel(x, y, EPS, iters, EPS0)


def worst(got, want):
    """Max over elements of |got - want| / (atol + rtol |want|): <= 1 passes."""
    return float(((got - want).abs() / (ATOL + RTOL * want.abs())).max())


def uniform(bsz, n, m, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    return (torch.rand(bsz, n, 3, device=device, generator=gen),
            torch.rand(bsz, m, 3, device=device, generator=gen))


def chip_smoke_case(bsz, n, device):
    """The clouds chip_smoke.py's kernels phase draws for (bsz, n)."""
    return tuple(torch.rand(bsz, n, 3, device=device,
                            generator=torch.Generator(device).manual_seed(s))
                 for s in (n, n + 1))


def train_clouds(n, device):
    """(pred, gt) of the batch-128 synthetic batch through the full-width
    generator at its unscaled init, in train mode."""
    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.models.generator import Generator, init_random_
    from fenet_torch.utils.device import full_fp32

    full_fp32()
    with torch.device(device):
        gen = Generator(num_points=n, **MODEL)
    init_random_(gen, torch.Generator(device=device).manual_seed(0))
    gen.to(device)
    ds = SyntheticShapeNet(n_models=6, num_points=n, variety=True, seed=0)
    batch = next(iter(DataLoader(ds, 128, shuffle=True, drop_last=True, seed=0)))
    images = torch.as_tensor(batch["image"].astype(np.uint8)).to(device)
    gen.train()
    with torch.no_grad():
        _, _, pred = gen(images)
    gt = torch.as_tensor(batch["points"]).to(device, torch.float32)
    del gen
    return pred.detach().contiguous(), gt.contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="LABEL=PATH")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sinkhorn_dev: needs a CUDA card", file=sys.stderr)
        return 1
    emit = Emitter("sinkhorn_dev.jsonl")
    device = torch.device("cuda", 0)
    emit({"device": card(), "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    loaded, failed = build(sources(args.source, "sinkhorn"), "sinkhorn", emit)
    emit({"build_s": time.perf_counter() - t0, "failed": failed})
    order = list(loaded) + list(reversed(list(loaded)))

    from fenet_torch.losses.sinkhorn import plan_loss
    from fenet_torch.ops.pairwise import pairwise_sqdist

    cases = []
    for bsz, n, iters in ((128, 1024, 300), (4, 2048, 300), (2, 8192, 30)):
        cases.append((f"smoke B={bsz} N=M={n} it={iters}", lambda b=bsz, n=n: chip_smoke_case(b, n, device),
                      iters, False))
    cases.append(("uniform B=128 N=M=2048 it=300",
                  lambda: uniform(128, 2048, 2048, device, 1), 300, False))
    for n in (1024, 2048):
        cases.append((f"train clouds B=128 N=M={n} it=300",
                      lambda n=n: train_clouds(n, device), 300, True))
    cases.append(("uniform B=2 N=5000 M=4096 it=20",
                  lambda: uniform(2, 5000, 4096, device, 2), 20, False))
    cases.append(("x30 B=3 N=M=1024 it=20",
                  lambda: (lambda x, y: (x * 30, y))(*uniform(3, 1024, 1024, device, 3)),
                  20, True))

    bad = 0
    for name, make, iters, with_loss in cases:
        try:
            x, y = make()
        except Exception:  # report the case and go on to the next
            emit({"case": name, "ok": False, "error": traceback.format_exc()})
            bad += 1
            continue
        t = time.perf_counter()
        f_p, g_p = sinkhorn._potentials_plain(x, y, EPS, iters, EPS0)
        torch.cuda.synchronize()
        row = {"case": name, "plain_ms": (time.perf_counter() - t) * 1e3,
               "x_abs_max": float(x.abs().max()), "y_abs_max": float(y.abs().max())}
        if with_loss:
            c = pairwise_sqdist(x, y)
            loss_p = float(plan_loss(c, c, f_p, g_p, EPS))
            row["loss_plain"] = loss_p
        on_cpu = None
        if name.startswith("x30"):
            # At this scale the card's plain version, which divides by e as
            # a product with RN(1/e), is off every kernel: the check is
            # against the plain version on the CPU, which divides. Also
            # whether the costs have the same bits on both.
            on_cpu = sinkhorn._potentials_plain(x.cpu(), y.cpu(), EPS, iters, EPS0)
            row["cost_bits_equal_share"] = float(
                (pairwise_sqdist(x, y).cpu() == pairwise_sqdist(x.cpu(), y.cpu())).float().mean())
        evals = 2 * x.shape[0] * x.shape[1] * y.shape[1] * iters
        reps = 2 if evals > 6e10 else 3
        per = {}
        for label in order:
            smi = sampler() if evals > 1e10 else None
            ms = event_ms(lambda: run(loaded[label], x, y, iters), reps)
            entry = per.setdefault(label, {"ms": [], "sm_mhz_w": []})
            entry["ms"].append(ms)
            if smi is not None:
                entry["sm_mhz_w"].append(clocks(smi))
        for label in loaded:
            f_k, g_k = run(loaded[label], x, y, iters)
            torch.cuda.synchronize()
            r = per[label]
            r["worst"] = max(worst(f_k, f_p), worst(g_k, g_p))
            r["max_abs_err"] = max(float((f_k - f_p).abs().max()), float((g_k - g_p).abs().max()))
            r["finite"] = bool(torch.isfinite(f_k).all() and torch.isfinite(g_k).all())
            if on_cpu is not None:
                r["worst_vs_cpu_plain"] = max(worst(f_k.cpu(), on_cpu[0]), worst(g_k.cpu(), on_cpu[1]))
            if with_loss:
                loss_k = float(plan_loss(c, c, f_k, g_k, EPS))
                r["loss_rel_err"] = abs(loss_k - loss_p) / abs(loss_p)
            r["ok"] = r["finite"] and r["worst" if on_cpu is None else "worst_vs_cpu_plain"] <= 1.0
            bad += not r["ok"]
        row["libs"] = per
        emit(row)
        del x, y, f_p, g_p
        if with_loss:
            del c
        torch.cuda.empty_cache()
    emit({"done": True, "failed_checks": bad, "failed_builds": failed})
    return 1 if bad or failed else 0


if __name__ == "__main__":
    sys.exit(main())
