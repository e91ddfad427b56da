"""The benchmark's definition: ``BENCHMARK.json`` against the rules of its
format and against the files of ``portbench/``, and the proof that a configuration, a
cell and a per-layer metric are each added as new files, with no file that
is there edited."""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import shutil
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402
from portbench.tests import tiny  # noqa: E402
from portbench.tests.tiny import LATER  # noqa: E402

HERE = harness.HERE
BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
METRIC_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"][1].startswith("portbench/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its 43200 s.
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(harness.NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25


def test_configs_are_files_of_their_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["reduced"] == [] and _line(c["why"]) and _line(c["source"])
        cfg = harness.load_config(c["name"])  # its reference and count kept their contracts
        assert harness.reference_module(cfg).parameter_count(cfg) == cfg["parameters"]
        assert harness.count_module(cfg).train_flops(cfg) > 0


def test_cells_match_their_files_and_report_the_required_metrics():
    """Every workload file is a cell of BENCHMARK.json or one kept for later,
    and holds only what BENCHMARK.json does not: the traffic kind, its
    parameters and the limits."""
    kinds = {p.stem for p in (HERE / "traffic").glob("*.py")}
    cells = BENCH["workloads"] + LATER["workloads"]
    assert {w["name"] for w in cells} == {p.stem for p in (HERE / "workloads").glob("*.json")}
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and _line(w["why"])
        assert harness.NAME.match(w["traffic"])
        cell = harness.load_cell(w["name"])
        assert cell == dict(w, **harness.load_json(HERE / "workloads" / f"{w['name']}.json"))
        assert cell["kind"] in kinds
        e2e, layer = harness.cell_metrics(BENCH, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for path in (HERE / "workloads").glob("*.json"):
        assert set(harness.load_json(path)) == {"kind", "params", "limits"}


@pytest.mark.parametrize("cell", ["train_a2_1024", "train_a2_2048_sinkhorn"])
def test_a_train_cell_sets_only_its_own_emd(cell):
    from portbench.traffic import train

    params = harness.load_cell(cell)["params"]
    for impl, keys in train.EMD_KEYS.items():
        assert all((k in params) == (impl == params["emd_impl"]) for k in keys)


def test_a_cell_missing_from_the_benchmark_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("eval_a2_1024")


def test_per_layer_metrics_have_readers_and_move_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"] + LATER["end_to_end"]}
    for m in BENCH["per_layer"] + LATER["per_layer"]:
        assert set(m) <= METRIC_KEYS and _line(m["layer"])
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for m in BENCH["per_layer"]:
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_configuration_a_cell_and_a_metric_are_new_files_only(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = _digest(base)
    config = json.loads((base / "configs" / "a2_1024.json").read_text())
    (base / "configs" / "a2_1024_wide.json").write_text(json.dumps(dict(config, fine_width=1024)))
    cell = json.loads((base / "workloads" / "train_a2_1024.json").read_text())
    (base / "workloads" / "train_a2_1024_wide.json").write_text(json.dumps(cell))
    (base / "metrics" / "steps.train.py").write_text(
        "def read(ctx, win):\n    return float(win.extra['steps']) or None\n")
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "train_a2_1024_wide", "config": "a2_1024_wide",
                               "traffic": "train_auction_wide", "chips": 1, "why": "wider"})
    bench["per_layer"].append({"name": "steps.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Step",
                               "moves": "train_samples_per_s",
                               "workloads": ["train_a2_1024", "train_a2_1024_wide"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_samples_per_s")["workloads"].append("train_a2_1024_wide")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    assert harness.load_config("a2_1024_wide", base)["fine_width"] == 1024
    assert harness.load_cell("train_a2_1024_wide", base)["config"] == "a2_1024_wide"
    e2e, layer = harness.cell_metrics(bench, "train_a2_1024_wide")
    assert [m["name"] for m in e2e] == ["train_samples_per_s", "setup_s"]
    assert "steps.train" in [m["name"] for m in layer]
    win = harness.Window(0.0, 1.0, 128, 1, 0, extra={"steps": 3})
    assert harness.reader("steps.train", base).read(None, win) == 3.0
    assert harness.traffic(harness.load_cell("train_a2_1024_wide", base)["kind"], base).setup


# A configuration of another architecture: the generator with a
# squeeze-and-excite gate on every block (RepVGG-D2se's block) at
# RepVGG-TEST's widths, its reference and count the fixtures beside this
# file, its cell the tiny train cell.
SE_FILES = {"configs/tiny_se.json", "reference/tiny_se.py", "counts/tiny_se.py",
            "workloads/tiny_se_train.json"}


def _se_layout(tmp_path: Path, monkeypatch) -> Path:
    """A tiny layout (``tiny.layout``) with the SE configuration and its
    cell added as new files; the SE backbone entered in the program's
    registry for this test alone."""
    from fenet_torch.models import repvgg

    monkeypatch.setitem(repvgg.REPVGG_CONFIGS, "RepVGG-TEST-SE",
                        dataclasses.replace(repvgg.REPVGG_CONFIGS["RepVGG-TEST"], use_se=True))
    base, root = tiny.layout(tmp_path)
    before = _digest(base)
    fixtures = Path(__file__).resolve().parent
    config = dict(tiny.TINY_CONFIG, reference="tiny_se", backbone="RepVGG-TEST-SE")
    (base / "configs" / "tiny_se.json").write_text(json.dumps(config))
    shutil.copy(fixtures / "se_reference.py", base / "reference" / "tiny_se.py")
    shutil.copy(fixtures / "se_counts.py", base / "counts" / "tiny_se.py")
    shutil.copy(base / "workloads" / "tiny_train.json", base / "workloads" / "tiny_se_train.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next(w for w in bench["workloads"] if w["name"] == "tiny_train")
    bench["workloads"].append(dict(entry, name="tiny_se_train", config="tiny_se"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tiny_train" in m.get("workloads", []):
            m["workloads"].append("tiny_se_train")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(base)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited
    assert set(after) - set(before) == SE_FILES
    return base


def test_a_configuration_of_another_architecture_is_new_files_only(tmp_path, monkeypatch):
    """Its reference holds the port's own SE generator at the same state,
    and its count the flop counter's FLOPs on the port."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from fenet_torch.models.generator import Generator

    base = _se_layout(tmp_path, monkeypatch)
    cfg = harness.load_config("tiny_se", base)
    ref, count = harness.reference_module(cfg, base), harness.count_module(cfg, base)
    plain = harness.load_config("tiny", base)
    arch = dict(num_points=cfg["num_points"], backbone=cfg["backbone"],
                fine_width=cfg["fine_width"], mid_width=cfg["mid_width"])
    state = ref.init(cfg, 11, "cpu", head_scale=0.03, random_bn=True)
    gen = Generator(**arch)
    gen.load_state_dict(state, strict=True)
    assert ref.parameter_count(cfg) == sum(p.numel() for p in gen.parameters())
    assert ref.parameter_count(cfg) > harness.reference_module(plain, base).parameter_count(plain)
    images = torch.randint(0, 256, (3, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    with torch.no_grad():  # eval first: a train-mode pass moves the port's statistics
        deployed = ref.deploy_forward(ref.fold(state, cfg), images, cfg)
        torch.testing.assert_close(deployed, gen.eval()(images)[2], rtol=1e-4, atol=1e-5)
        for train in (False, True):
            for got, want in zip(ref.forward(state, images, cfg, train), gen.train(train)(images)):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    with torch.device("meta"):
        gen, deploy = Generator(**arch), Generator(**arch, deploy=True)
        images = torch.zeros((1, cfg["image_hw"], cfg["image_hw"], 3))
        with FlopCounterMode(display=False) as forward:
            gen(images)
        with FlopCounterMode(display=False) as train:
            gen(images)[2].sum().backward()
        with FlopCounterMode(display=False) as folded:
            deploy(images)
    assert count.forward_flops(cfg) == forward.get_total_flops()
    assert count.train_flops(cfg) == train.get_total_flops()
    assert count.deploy_flops(cfg) == folded.get_total_flops()


def test_a_cell_of_another_architecture_runs_correct_by_its_own_reference_and_count(
        tmp_path, monkeypatch):
    """A traced tiny train cell on the SE configuration: correct, its
    reference and count the ones it names (the generator's, as the harness
    loads them, never called), and ``mfu.train`` divided by its own count."""
    import torch

    from portbench import tracing

    base = _se_layout(tmp_path, monkeypatch)
    cfg, plain = harness.load_config("tiny_se", base), harness.load_config("tiny", base)
    called = []
    for config in (cfg, plain):
        for module in (harness.reference_module(config, base), harness.count_module(config, base)):
            for fn in ("init", "spec", "forward", "train_flops"):
                if hasattr(module, fn):
                    def spy(*args, _fn=getattr(module, fn), _name=f"{config['reference']}.{fn}",
                            **kwargs):
                        called.append(_name)
                        return _fn(*args, **kwargs)
                    monkeypatch.setattr(module, fn, spy)
    result, _ = tiny.run(tmp_path, "tiny_se_train", trace=True, base=base)
    assert result["correct"], result["checks"]
    assert {"tiny_se.init", "tiny_se.spec", "tiny_se.forward", "tiny_se.train_flops"} <= set(called)
    assert not [c for c in called if c.startswith("generator.")]
    assert "mfu.train" in result["metrics"]
    count = harness.count_module(cfg, base)
    ctx = harness.Context(harness.load_cell("tiny_se_train", base), cfg, 1, 1.0, True,
                          torch.device("cpu"), harness.load_json(base / "peaks.json"), base)
    win = harness.Window(0.0, 1.0, 8, 2, 0, tracing.Trace(2.0, [], []))
    mfu = harness.reader("mfu.train", base).read(ctx, win)
    assert mfu == pytest.approx(100.0 * count.train_flops(cfg) * 4.0
                                / ctx.peaks["float32_flops_per_s"])
    assert count.train_flops(cfg) > harness.count_module(plain, base).train_flops(plain)


# A configuration whose reference or count is not there or breaks its
# contract: (its reference key, the files written beside it, the file at
# fault, what the message names besides).
GEN, COUNT = ("from portbench.reference.generator import *  # noqa\n",
              "from portbench.counts.generator import *  # noqa\n")
BROKEN = {
    "no_key": (None, {}, "configs/broken.json", "'reference'"),
    "no_reference": ("nowhere", {}, "reference/nowhere.py", "'nowhere'"),
    "no_count": ("halfway", {"reference/halfway.py": GEN}, "counts/halfway.py", "'halfway'"),
    "a_reference_function_missing": (
        "short", {"reference/short.py": "from portbench.reference.generator import (spec, "
                                        "parameter_count, init, forward, fold)  # noqa\n",
                  "counts/short.py": COUNT}, "reference/short.py", "deploy_forward"),
    "a_reference_signature_changed": (
        "narrow", {"reference/narrow.py": GEN + "def init(cfg, seed):\n    return {}\n",
                   "counts/narrow.py": COUNT}, "reference/narrow.py", "init("),
    "a_count_function_missing": (
        "uncounted", {"reference/uncounted.py": GEN, "counts/uncounted.py":
                      "from portbench.counts.generator import forward_flops  # noqa\n"},
        "counts/uncounted.py", "train_flops"),
}


@pytest.mark.parametrize("fault", list(BROKEN))
def test_a_configuration_without_a_sound_reference_is_refused_at_load(tmp_path, fault):
    """Refused at load, with a message that names the file at fault."""
    base = tmp_path / "portbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    name, files, at_fault, named = BROKEN[fault]
    config = json.loads((base / "configs" / "a2_1024.json").read_text())
    del config["reference"]
    if name is not None:
        config["reference"] = name
    (base / "configs" / "broken.json").write_text(json.dumps(config))
    for path, text in files.items():
        (base / path).write_text(text)
    with pytest.raises((ValueError, FileNotFoundError)) as err:
        harness.load_config("broken", base)
    assert str(base / at_fault) in str(err.value) and named in str(err.value)


@pytest.mark.parametrize("name", ["a b", "a,b", "a/b", "", "é", "-x", "x" * 65, "a\n"])
def test_names_outside_the_allowed_characters_are_refused(name):
    assert not harness.NAME.match(name)
    with pytest.raises(ValueError):
        harness.named_file("workloads", name, ".json")


@pytest.mark.parametrize("unit,ok", [("samples/s", True), ("%", True), ("ms", True),
                                     ("tokens per s", False), ("µs", False), ("", False)])
def test_units_are_checked(unit, ok):
    assert bool(harness.UNIT.match(unit)) == ok


def test_seed_streams_take_large_seeds():
    from portbench import inputs

    seeds = {inputs.stream_seed(2 ** 31 + 5, s) for s in range(5)}
    assert len(seeds) == 5 and all(0 <= s < 2 ** 63 for s in seeds)
    assert not math.isnan(float(inputs.uniform_clouds(2 ** 40, 1, 4, "cpu").sum()))
