"""The plain references against ``visfd_tpu_torch`` on the CPU at a
tiny size, their own pieces against brute force, and the control (the
reference in bfloat16) against the cells' limits."""

import itertools
import math

import numpy as np
import pytest
import torch

from portbench.harness import manifest
from portbench.harness.cell import Requests
from portbench.references import blob_ribosome as B
from portbench.references import membrane_tv as M
from visfd_tpu_torch.cli import filter_mrc
from visfd_tpu_torch.utils.progress import Report

from .conftest import TINY, write_inputs


def _program_once(workload, tmp_path, seed):
    cell = manifest.cell(workload)
    inputs = write_inputs(cell, TINY[workload], seed, str(tmp_path))
    reqs = Requests(cell.config, inputs, str(tmp_path))
    outputs = reqs.outputs(True)
    assert filter_mrc.run(reqs.argv(outputs), device="cpu",
                          report=Report(None)) == 0
    return cell, inputs, outputs


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
@pytest.mark.parametrize("workload", list(TINY))
def test_reference_agrees_with_the_port(workload, seed, tmp_path):
    cell, inputs, outputs = _program_once(workload, tmp_path, seed)
    nums, info = cell.reference().check(outputs, inputs, cell.config, "cpu")
    for k, limit in cell.config["limits"].items():
        assert nums[k] <= limit, (k, nums[k], limit)
    if workload.startswith("blob"):
        assert info["matched"] > 50


@pytest.mark.parametrize("workload", list(TINY))
def test_control_fails_a_limit(workload, tmp_path):
    cell = manifest.cell(workload)
    inputs = write_inputs(cell, TINY[workload], 5, str(tmp_path))
    nums = cell.reference().control(inputs, cell.config, "cpu")
    assert any(nums[k] > lim for k, lim in cell.config["limits"].items())


def test_eigen_against_linalg():
    g = torch.Generator().manual_seed(0)
    t = torch.randn((6, 500), generator=g, dtype=torch.float64)
    t[:, :3] = torch.tensor([[2.0] * 3, [2.0] * 3, [-1.0] * 3,
                             [0.0] * 3, [0.0] * 3, [0.0] * 3])
    l0, l1, l2 = M.eigenvalues(t)
    a, b, c, d, e, f = t
    mat = torch.stack([torch.stack([a, d, f]), torch.stack([d, b, e]),
                       torch.stack([f, e, c])]).permute(2, 0, 1)
    vals, vecs = torch.linalg.eigh(mat)
    assert torch.allclose(torch.stack([l0, l1, l2]),
                          vals.flip(-1).T, atol=1e-12)
    v = M.principal_vector(t, l0)[:, 3:]
    dots = (v * vecs[3:, :, 2].T).sum(0).abs()
    assert torch.allclose(dots, torch.ones_like(dots), atol=1e-9)


def test_vote_against_a_receiver_loop():
    """Each receiver's vote summed over its sources by hand."""
    g = torch.Generator().manual_seed(1)
    shape = (5, 6, 7)
    sal = torch.rand(shape, generator=g, dtype=torch.float64)
    sal[sal < 0.7] = 0
    vec = torch.randn((3,) + shape, generator=g, dtype=torch.float64)
    vec = vec / vec.norm(dim=0)
    sigma, hw = 1.3, 2
    got = M.vote(sal, vec, sigma, hw, 4)
    table = M.gen_gauss_table(sigma, hw)
    want = torch.zeros_like(got)
    for z, y, x in itertools.product(*map(range, shape)):
        for jz, jy, jx in zip(*np.nonzero(table)):
            j = (jz - hw, jy - hw, jx - hw)
            s = (z - j[0], y - j[1], x - j[2])
            if not all(0 <= s[i] < shape[i] for i in range(3)):
                continue
            ln = math.sqrt(sum(v * v for v in j)) or 1.0
            rh = torch.tensor([j[2] / ln, j[1] / ln, j[0] / ln],
                              dtype=torch.float64)
            n = vec[:, s[0], s[1], s[2]]
            sin = float(n @ rh)
            nr = 2 * sin * rh - n
            amp = float(sal[s]) * table[jz, jy, jx] * (1 - sin * sin) ** 2
            want[:, z, y, x] += amp * torch.stack([
                nr[0] * nr[0], nr[1] * nr[1], nr[2] * nr[2],
                nr[0] * nr[1], nr[1] * nr[2], nr[0] * nr[2]])
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-15)


def test_minima_against_eighty_neighbours():
    g = torch.Generator().manual_seed(2)
    vols = [torch.randn((6, 7, 8), generator=g) for _ in range(3)]
    mask = torch.ones((6, 7, 8))
    mask[0, 0, 0] = 0
    vols[1][2, 3, 4] = -10.0
    ring = [B._nan_padded(v, mask) for v in vols]
    flat, vals = B._minima(ring)
    want = []
    for z, y, x in itertools.product(range(6), range(7), range(8)):
        c = ring[1][z + 1, y + 1, x + 1]
        nbs = [r[z + 1 + dz, y + 1 + dy, x + 1 + dx]
               for k, r in enumerate(ring)
               for dz, dy, dx in B.OFFSETS
               if not (k == 1 and dz == dy == dx == 0)]
        if c < 0 and all(bool(nb > c) for nb in nbs):
            want.append((z * 7 + y) * 8 + x)
    assert flat.tolist() == want and (z * 0 + 2 * 56 + 3 * 8 + 4) in want


def test_flip_distance():
    ring = [torch.full((5, 5, 5), 1.0) for _ in range(3)]
    ring[1][2, 2, 2] = -2.0
    ring[1][2, 2, 3] = -1.5
    flat = torch.tensor([(1 * 3 + 1) * 3 + 1, (1 * 3 + 1) * 3 + 2])
    d_min = B._flip_distance(ring, flat[:1], True)
    assert float(d_min[0]) == pytest.approx(0.5)
    d_not = B._flip_distance(ring, flat[1:], False)
    assert float(d_not[0]) == pytest.approx(0.5)
    ring[0][1, 1, 2] = float("nan")
    assert math.isinf(float(B._flip_distance(ring, flat[1:], False)[0]))
