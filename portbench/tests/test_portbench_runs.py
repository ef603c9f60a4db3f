"""Whole runs of the harness on the CPU at a tiny size (its look for a
card skipped): a sound run is correct, a run with the timed path broken
underneath is not, a run that loaded JAX prints no result, and the
command without a card, or without the program beside it, prints none
either.  The test marked ``cuda`` runs a tiny cell on the card."""

import ast
import dataclasses
import glob
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

from portbench.harness import manifest
from portbench.harness.cell import FORBIDDEN, forbidden_modules
from visfd_tpu_torch.cli import filter_mrc

from .conftest import TINY, run_tiny

ROOT = manifest.ROOT
YARDSTICK = (glob.glob(os.path.join(manifest.HERE, "references", "*.py"))
             + glob.glob(os.path.join(manifest.HERE, "roofline", "*.py"))
             + glob.glob(os.path.join(manifest.HERE, "traffic", "kinds",
                                      "*.py"))
             + [os.path.join(manifest.HERE, "traffic", "phantoms.py"),
                os.path.join(manifest.HERE, "harness", "plain.py"),
                os.path.join(manifest.HERE, "harness", "mrcfile.py")])


@pytest.mark.parametrize("workload", list(TINY))
def test_sound_run_is_correct(workload):
    rc, res, err = run_tiny(workload)
    assert rc == 0 and res["correct"], err[-2000:]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"voxels_per_s", "card_peak_gib",
                                   "host_peak_gib", "setup_s"}
    assert err.strip().splitlines()[-1].startswith("check ")


def test_new_traffic_kind_runs_correct_with_no_edit():
    """A cell the test makes from membrane_tv's config and a traffic of
    the ``smoothed`` kind (a dict, in no file the harness knows) runs
    through run_cell and is correct."""
    base = manifest.cell("membrane_tv.tomo268m")
    traffic = dict(base.traffic, name="smoothed_membrane", phantom={
        "kind": "smoothed", "of": base.traffic["phantom"], "sigma_A": 40.0})
    cell = dataclasses.replace(base, name="membrane_tv.smoothed",
                               traffic=traffic)
    rc, res, err = run_tiny(cell)
    assert rc == 0 and res["correct"], err[-2000:]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_traced_run_reports_the_per_layer_metrics():
    """With --trace 1 the metrics are the cell's per-layer ones that find
    something to read (the CPU's trace has no kernel of the port), with
    the device's busy and window seconds and a breakdown."""
    rc, res, err = run_tiny("membrane_tv.tomo268m", trace=True)
    assert rc == 0 and res["correct"], err[-2000:]
    cell = manifest.cell("membrane_tv.tomo268m")
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert {"host_unstaged_s", "mrc_read_s", "membrane_stages_s",
            "device_idle_pct"} <= set(res["metrics"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_altered_tomogram_is_not_correct(monkeypatch):
    write = filter_mrc.mrc.write_mrc

    def one_plane_lost(f, data, **kw):
        data = np.array(data)
        data[len(data) // 2] = 0
        return write(f, data, **kw)
    monkeypatch.setattr(filter_mrc.mrc, "write_mrc", one_plane_lost)
    rc, res, _ = run_tiny("membrane_tv.tomo268m")
    assert rc == 0 and not res["correct"]
    c = res["checks"]["rel_l2"]
    assert c["value"] > c["limit"]


def test_moved_blob_is_not_correct(monkeypatch):
    write = filter_mrc.write_blob_coords_file

    def deepest_moved(path, crds, diameters, scores):
        crds = np.array(crds)
        crds[int(np.argmin(scores)), 0] += 19.6
        return write(path, crds, diameters, scores)
    monkeypatch.setattr(filter_mrc, "write_blob_coords_file", deepest_moved)
    rc, res, _ = run_tiny("blob_ribosome.tomo268m")
    assert rc == 0 and not res["correct"]
    c = res["checks"]["tie_margin"]
    assert c["value"] > c["limit"]


def test_missing_output_is_not_correct(monkeypatch):
    monkeypatch.setattr(filter_mrc.mrc, "write_mrc", lambda *a, **k: None)
    rc, res, _ = run_tiny("membrane_tv.tomo268m")
    assert rc == 0 and not res["correct"]
    assert res["checks"]["rel_l2"]["value"] > res["checks"]["rel_l2"]["limit"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert forbidden_modules() == ["jax"]
    rc, res, err = run_tiny("membrane_tv.tomo268m")
    assert rc != 0 and res is None and "jax" in err


def test_top_level_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "visfd_tpu_torch.x", types.ModuleType(
        "visfd_tpu_torch.x"))
    assert "visfd_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "visfd_tpu.io", types.ModuleType(
        "visfd_tpu.io"))
    assert forbidden_modules() == ["visfd_tpu"]


@pytest.mark.parametrize("path", YARDSTICK)
def test_yardstick_imports_nothing_of_the_program(path):
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & (set(FORBIDDEN) | {"visfd_tpu_torch"}), tops


def test_yardstick_loads_nothing_of_the_program():
    kinds = "".join(
        f", portbench.traffic.kinds.{os.path.basename(p)[:-3]}"
        for p in glob.glob(os.path.join(manifest.HERE, "traffic", "kinds",
                                        "[!_]*.py")))
    code = ("import sys; import portbench.references.membrane_tv, "
            "portbench.references.blob_ribosome, portbench.traffic.phantoms,"
            f" portbench.roofline{kinds}; print(sorted({{m.split('.')[0] "
            "for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'visfd_tpu', "
            "'visfd_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_command_without_a_card_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "membrane_tv.tomo268m", "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_without_the_program_there_is_no_result(tmp_path):
    """A directory of BENCHMARK.json and portbench/ alone."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path.insert(0, '.'); "
            "from portbench.harness import manifest; "
            "from portbench.harness.cell import run_cell; "
            "c = manifest.cell('membrane_tv.tomo268m', '.'); "
            "sys.exit(run_cell(c, 1, 0.01, False, time.perf_counter(), "
            "device='cpu', shape=(16, 32, 32)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "visfd_tpu_torch" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(TINY))
def test_tiny_cell_on_the_card(workload, card):
    from portbench.harness.cell import run_cell
    import io
    import time
    cell = manifest.cell(workload)
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, 17, 0.01, True, time.perf_counter(), device=card,
                  shape=TINY[workload], out=out, err=err)
    assert rc == 0, err.getvalue()[-3000:]
    assert '"correct": true' in out.getvalue()
