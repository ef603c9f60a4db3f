"""Shared fixtures of the benchmark's CPU tests: tiny cells, their
inputs written as the harness writes them, and a card fixture for the
tests marked ``cuda``."""

import io
import json
import os
import time

import pytest

from portbench.harness import manifest, mrcfile
from portbench.traffic import phantoms

# every cell of BENCHMARK.json at the size its traffic file gives the
# CPU (``tiny_zyx``), so a cell added to the manifest joins the tests
TINY = {w["name"]: tuple(manifest.cell(w["name"]).traffic["tiny_zyx"])
        for w in manifest.load_json(os.path.join(
            manifest.ROOT, "BENCHMARK.json"))["workloads"]}


@pytest.fixture
def card():
    """Skips without a CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def write_inputs(cell, shape, seed, directory):
    w = cell.config["parameters"]["voxel_width_A"]
    vol, mask = phantoms.make(cell.traffic, shape, w, seed, "cpu")
    inputs = {"input": os.path.join(directory, "input.mrc")}
    mrcfile.write(inputs["input"], vol.numpy(), w)
    if mask is not None:
        inputs["mask"] = os.path.join(directory, "mask.mrc")
        mrcfile.write(inputs["mask"], mask.numpy(), w)
    return inputs


def run_tiny(workload, seed=2 ** 31 + 7, seconds=0.01, trace=False):
    """(exit code, result or None, stderr) of one CPU run of a tiny
    cell (a workload's name, or a ``Cell``) through the harness, at its
    traffic's ``tiny_zyx``."""
    from portbench.harness.cell import run_cell
    cell = (manifest.cell(workload) if isinstance(workload, str)
            else workload)
    out, err = io.StringIO(), io.StringIO()
    rc = run_cell(cell, seed, seconds, trace, time.perf_counter(),
                  device="cpu", shape=tuple(cell.traffic["tiny_zyx"]),
                  out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
