"""Every cell, configuration, traffic mix, loop and metric that
BENCHMARK.json names parses and is found by name; a throwaway cell added
as new files runs with no existing file edited."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from harness import registry

REPO = os.path.dirname(registry.ROOT)


def _bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_names_are_found():
    b = _bench()
    metrics = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    for cfg in b["configs"]:
        data = registry.load_json("configs", cfg["name"])
        assert cfg["file"] == f"bench_port/configs/{cfg['name']}.json"
        assert data["source"] == cfg["source"]
        assert data["reduced"] == cfg["reduced"]
    for wl in b["workloads"]:
        c = registry.cell(wl["name"])
        assert (c["config"], c["traffic"], c["chips"]) == (
            wl["config"], wl["traffic"], wl["chips"])
        registry.load_module("loops", c["loop"])
        for n in c["end_to_end"] + c["per_layer"]:
            mod = registry.load_module("metrics", n)
            assert mod.UNIT == metrics[n]["unit"], n
            assert callable(mod.read)
        # a per-layer metric reported here moves an end-to-end one the
        # cell reports
        for n in c["per_layer"]:
            assert metrics[n]["moves"] in c["end_to_end"], n
            assert wl["name"] in metrics[n].get("workloads", [wl["name"]])
        assert c["limits"] and c["compare_steps"] >= 1


@pytest.mark.parametrize("kind,ext", [("cells", ".json"),
                                      ("configs", ".json"),
                                      ("traffic", ".json"),
                                      ("loops", ".py"),
                                      ("metrics", ".py")])
def test_every_file_parses(kind, ext):
    for name in registry.names(kind, ext):
        if ext == ".json":
            assert isinstance(registry.load_json(kind, name), dict)
        else:
            registry.load_module(kind, name)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        registry.cell("no.such.cell")
    with pytest.raises(KeyError):
        registry.load_module("metrics", "no_such_metric")


def _run_copy(copy, tmp_path, cell: str):
    code = (
        "import sys, time, json\n"
        f"sys.path[:0] = [{str(copy)!r}, {REPO!r}]\n"
        "from harness import cli, registry\n"
        f"assert registry.ROOT == {str(copy)!r}\n"
        f"c = registry.cell({cell!r})\n"
        "r, _ = cli.run_cell(c, 7, 0.1, False, time.perf_counter(), 'cpu')\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _copy(tmp_path):
    copy = tmp_path / "bench_port"
    shutil.copytree(registry.ROOT, copy,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return copy, {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}


def test_a_cell_is_added_as_new_files(tmp_path):
    """A throwaway cell, traffic mix and per-layer metric, added to a copy
    of the benchmark as new files, are found and run; no file that was
    there is edited."""
    copy, before = _copy(tmp_path)
    (copy / "traffic" / "tiny_w2.json").write_text(json.dumps(
        {"size": {"scale": 0.2}, "worlds": 2, "episode_steps": 4,
         "particle_jitter": 0.0025, "param_spread": 0.2}))
    (copy / "metrics" / "episodes_seen.py").write_text(
        'UNIT = "episodes"\n\n\ndef read(ctx):\n'
        '    return ctx.window.steps / 4\n')
    cell = json.loads((copy / "cells" / "water_tank_inner.batch.json").read_text())
    cell.update(traffic="tiny_w2", end_to_end=["episodes_seen"])
    (copy / "cells" / "throwaway.json").write_text(json.dumps(cell))
    res = _run_copy(copy, tmp_path, "throwaway")
    assert res["correct"] is True
    assert res["metrics"]["episodes_seen"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_a_configuration_is_added_as_new_files(tmp_path):
    """A throwaway configuration of the same scene (a narrower tank with a
    shallower pool) and a cell of it run correct
    from new files alone; a configuration whose scene has no reference
    is refused by name."""
    copy, before = _copy(tmp_path)
    cfg = json.loads((copy / "configs" / "water_tank_inner.json").read_text())
    cfg.update(name="narrow_tank", tank_lower=[-1.0, 0.0],
               tank_upper=[1.0, 2.0], column_center=[0.0, 0.21],
               column_half=[1.0, 0.2])
    (copy / "configs" / "narrow_tank.json").write_text(json.dumps(cfg))
    (copy / "traffic" / "tiny_two.json").write_text(json.dumps(
        {"size": {"scale": 0.3}, "worlds": 2, "episode_steps": 4,
         "particle_jitter": 0.0025}))
    cell = json.loads((copy / "cells" / "water_tank_inner.batch.json").read_text())
    cell.update(config="narrow_tank", traffic="tiny_two")
    (copy / "cells" / "narrow.json").write_text(json.dumps(cell))
    res = _run_copy(copy, tmp_path, "narrow")
    assert res["correct"] is True
    assert res["checks"]["spawn_m"]["value"] == 0.0
    cfg.update(name="no_ref", scene="no_such_scene")
    (copy / "configs" / "no_ref.json").write_text(json.dumps(cfg))
    cell.update(config="no_ref")
    (copy / "cells" / "no_ref.json").write_text(json.dumps(cell))
    with pytest.raises(AssertionError, match="no reference for scene"):
        _run_copy(copy, tmp_path, "no_ref")
    for p, data in before.items():
        assert p.read_bytes() == data, p
