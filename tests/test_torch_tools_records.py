"""The port's training-evidence tools against fenet's, continued from
``tests/test_torch_tools.py`` (whose script runs the port's side here too,
in a subprocess: torch autograd and XLA:CPU corrupt the heap in one
process): the Sinkhorn tool's cross-eval, the finetune tool's warm ->
faithful and warm -> squash sequence, and the records' keys.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from fenet.losses.facade import chamfer_loss as jax_chamfer_loss
from fenet.losses.facade import emd_loss as jax_emd_loss
from fenet.train.config import TrainConfig as JaxTrainConfig
from fenet.train.trainer import Trainer as JaxTrainer
from fenet_torch.models.generator import Generator
from fenet_torch.tools import equiv_common, finetune_convergence, sinkhorn_equiv
from test_torch_tools import (BATCH, EMD_ITERS, FINETUNE, POINTS_SCORED, REPO, SMALL, WARM,
                              _fenet_init, _run_port)
from test_torch_tools import _one_torch_thread, assignments, small_generator  # noqa: F401 (fixtures)
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)


def test_cross_eval_score_matches_fenet(small_generator):
    """sinkhorn_equiv.score against fenet's ``score`` (tools/
    sinkhorn_equiv.py:68-76) on the same converted weights and held-out
    batch: CD to rtol 1e-4, the auction EMD to 5% (the eval path's bound:
    the predictions differ by ~1e-7 and the auction resolves near-ties on
    them). Scoring leaves the model's weights and statistics as they were.
    At 256 points (the held-out batch's first 256 of each cloud): on an
    untrained model's clouds the strict auction runs all its 3000
    iterations, which at 1024 points takes the port's plain version ~75 s
    on the CPU."""
    cfg = JaxTrainConfig(batch_size=BATCH, **SMALL)
    model, state, init = _fenet_init(cfg, POINTS_SCORED)
    _, (img, pts) = equiv_common.make_batches(1, BATCH)
    pts = pts[:, :POINTS_SCORED]

    @jax.jit
    def score(params, batch_stats, img, pts):
        (_, _, pc3), _ = model.apply({"params": params, "batch_stats": batch_stats},
                                     img.astype(jnp.float32), train=True,
                                     mutable=["batch_stats"])
        return (jax_chamfer_loss(pc3, pts), jax_emd_loss(pc3, pts, 0.05, 3000))

    cd, emd = (float(v) for v in score(state.params, state.batch_stats, jnp.asarray(img),
                                       jnp.asarray(pts)))
    gen = Generator(num_points=POINTS_SCORED, **SMALL)
    gen.load_state_dict({k: torch.tensor(v) for k, v in init.items()}, strict=True)
    gen.eval()
    before = {k: v.clone() for k, v in gen.state_dict().items()}
    got = sinkhorn_equiv.score(gen, img, pts)
    np.testing.assert_allclose(got["chamfer"], cd, rtol=1e-4)
    np.testing.assert_allclose(got["auction_emd"], emd, rtol=5e-2)
    assert not gen.training
    for key, value in gen.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_finetune_sequence_matches_fenet(tmp_path, small_generator, assignments):
    """fenet's finetune tool's sequence (tools/finetune_convergence.py:
    80-98), a few steps a phase: schedule-loss warm steps, then the faithful
    and the squashed finetune phases, each from the same warm TrainState.

    The port against it at test_torch_finetune's bounds (rtol
    5e-3·(step+1), the step counted from the warm phase's first): every
    warm and squashed step, and the faithful phase's first step. After that
    first faithful update the faithful phase is only held finite: its BCE on
    raw splat sums is ill-conditioned (a cell's gradient is 1/(1 - pred)),
    and one update amplifies float32 differences. Measured on this batch,
    from fenet's own warm state (weights, statistics and Adam moments
    converted): the port's first faithful step within 5.4e-7 of fenet's,
    its second 2.1e-2 off in the total (1.5e-4 in CD), its fourth of the
    other sign; the squashed phase from the same state within 6.4e-5 over
    four steps.

    And the port's squashed phase step for step the same whether or not the
    faithful phase ran before it: the faithful phase advances neither the
    weights nor the Adam state the squashed one starts from."""
    cfg = JaxTrainConfig(batch_size=BATCH, emd_iters=EMD_ITERS, **SMALL)
    model, state, init = _fenet_init(cfg)
    images, points = finetune_convergence.fixed_batch(BATCH)
    img, pts = jnp.asarray(images), jnp.asarray(points)

    def run_phase(trainer, state, steps, lr):
        trace = []
        for _ in range(steps):
            state, stats = trainer.train_step(state, img, pts, epoch=1, lr=lr)
            trace.append([float(stats[k]) for k in ("total_loss", "chamfer_loss", "emd_loss")])
        return state, trace

    want, recorded = {}, {}
    warm_state, want["warm"] = run_phase(JaxTrainer(model, cfg, loss_mode="schedule"), state,
                                         WARM, cfg.lr)
    recorded["warm"] = assignments[:]
    for phase in ("faithful", "squash"):
        del assignments[:]
        phase_cfg = dataclasses.replace(cfg, proj_squash=phase == "squash")
        _, want[phase] = run_phase(JaxTrainer(model, phase_cfg, loss_mode="finetune"),
                                   warm_state, FINETUNE, 5e-5)
        recorded[phase] = assignments[:]
    got = _run_port(tmp_path, kind="finetune",
                    **{f"ass_{phase}": np.stack(a) for phase, a in recorded.items()},
                    **{f"sd.{k}": v for k, v in init.items()})
    held = {"warm": (0, WARM), "faithful": (WARM, 1), "squash": (WARM, FINETUNE)}
    for phase, (first, steps) in held.items():
        for i in range(steps):
            np.testing.assert_allclose(got[f"faithful+squash.{phase}"][i], want[phase][i],
                                       rtol=5e-3 * (first + i + 1), err_msg=f"{phase} step {i}")
    assert np.isfinite(got["faithful+squash.faithful"]).all()
    np.testing.assert_array_equal(got["faithful+squash.squash"], got["squash.squash"])
    np.testing.assert_array_equal(got["faithful+squash.warm"], got["squash.warm"])


def _keys(record):
    """A record's key structure: dicts by key, lists by their first item."""
    if isinstance(record, dict):
        return {k: _keys(v) for k, v in record.items()}
    if isinstance(record, list):
        return [_keys(record[0])] if record else []
    return None


# Keys of fenet's committed records that fenet's tools never write (added to
# the records by hand after their runs).
HAND_ADDED = ("reading", "trailing_window")


def test_tool_records_have_fenets_keys(tmp_path):
    _run_port(tmp_path, kind="records")
    for ours, theirs, tool in (("eps.json", "eps_scaling_equiv.json", "eps_scaling_equiv"),
                               ("sinkhorn.json", "sinkhorn_equiv.json", "sinkhorn_equiv"),
                               ("finetune.json", "finetune_onchip_convergence.json",
                                "finetune_convergence")):
        got = json.loads((tmp_path / ours).read_text())
        want = json.loads((REPO / "docs" / theirs).read_text())
        source = (REPO / "tools" / f"{tool}.py").read_text()
        for key in HAND_ADDED:
            if key in want:
                assert f'"{key}"' not in source
                del want[key]
        assert got.pop("device") == "cpu"
        assert _keys(got) == _keys(want), tool
    finetune = json.loads((tmp_path / "finetune.json").read_text())
    assert finetune["all_finite"] and finetune["commit"] == finetune_convergence.commit()
    assert len(finetune["warm_trace"]) == len(finetune["squash_trace"]) == 1


def test_commit_is_empty_without_git(tmp_path, monkeypatch):
    """A ``git archive`` tree has no .git: the finetune record's commit is
    "" there, not the commit of a repository around it."""
    monkeypatch.setattr(equiv_common, "ROOT", tmp_path)
    assert finetune_convergence.commit() == ""
