"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import math
import os
import re
import shutil

import pytest

from portbench.harness import manifest

MAN = manifest.load_json(os.path.join(manifest.ROOT, "BENCHMARK.json"))
WORKLOADS = [w["name"] for w in MAN["workloads"]]


def test_manifest_has_no_problems():
    assert manifest.check(MAN) == []
    assert manifest.check() == []


@pytest.mark.parametrize("phantom", [
    {"kind": "no_such"},
    {"kind": "smoothed", "sigma_A": 40.0, "of": {"kind": "no_such"}}])
def test_check_names_a_missing_phantom_kind(phantom, tmp_path,
                                            monkeypatch):
    """A traffic whose phantom (or a phantom nested in it) is of a kind
    neither built in nor a file under traffic/kinds/."""
    here = tmp_path / "portbench"
    shutil.copytree(manifest.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (here / "traffic" / "odd.json").write_text(json.dumps(
        {"name": "odd", "clients": 1, "tiny_zyx": [8, 8, 8],
         "phantom": phantom}))
    monkeypatch.setattr(manifest, "HERE", str(here))
    man = json.loads(json.dumps(MAN))
    man["workloads"].append(dict(man["workloads"][0], name="membrane_tv.odd",
                                 traffic="odd"))
    assert manifest.check(man) == [
        "no phantom kind no_such for membrane_tv.odd"]


def test_command_and_paths():
    assert MAN["command"][:2] == ["python3", "portbench/run.py"]
    assert len(MAN["command"]) <= 32
    for p in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_contract_keys_and_limits():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["bound"] >= 0.01
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].startswith("roofline."):
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = manifest.cell(workload)
    assert cell.end_to_end and cell.per_layer
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)
    ref = cell.reference()
    assert callable(ref.check) and callable(ref.control)
    assert set(cell.config["limits"]) and all(
        v is not None and math.isfinite(v) and v >= 0
        for v in cell.config["limits"].values())
    for key in cell.config["outputs"]:
        assert "{" + key + "}" in cell.config["argv"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_config_matches_the_port_s_parser(workload):
    """The config's parameters are what the port's settings parser makes
    of its flags (the reference and the rooflines read the former)."""
    import numpy as np
    from visfd_tpu_torch.cli import settings as S
    cell = manifest.cell(workload)
    p = cell.config["parameters"]
    argv = [{"{input}": "in.mrc", "{output}": "out.mrc", "{mask}": "m.mrc",
             "{minima}": "b.txt"}.get(a, a) for a in cell.config["argv"]]
    s = S.parse_args(argv)
    assert s.voxel_width == p["voxel_width_A"]
    if "bin" in p:
        assert s.resize_with_binning == p["bin"]
        assert s.width_a[0] == pytest.approx(p["thickness_A"] / np.sqrt(3))
        assert s.tv_sigma == pytest.approx(
            p["tv_sigma_per_blur_sigma"] * s.width_a[0])
        assert s.tv_exponent == p["tv_exponent"]
        assert s.hessian_score_threshold == p["tv_best"]
        assert s.tv_truncate_ratio == p["tv_truncate_ratio"]
        assert s.filter_truncate_threshold == p["filter_truncate_threshold"]
    else:
        from portbench.references import blob_ribosome as R
        assert np.allclose(np.asarray(s.blob_diameters) / p["voxel_width_A"],
                           R.ladder_diameters(p), rtol=0, atol=0)
        assert s.delta_sigma_over_sigma == p["delta_sigma_over_sigma"]
        assert s.filter_truncate_threshold == p["filter_truncate_threshold"]
        assert s.nonmax_min_radial_separation_ratio == 0.0


def test_traffic_files_are_data():
    for w in MAN["workloads"]:
        path = os.path.join(manifest.HERE, "traffic", f"{w['traffic']}.json")
        t = json.load(open(path))
        assert t["clients"] == 1 and "kind" in t["phantom"]
        assert len(t["tiny_zyx"]) == 3
