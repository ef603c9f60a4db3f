"""The PyTorch port's slice end to end: a synthetic phantom MRC through
``visfd_tpu.cli.filter_mrc.run`` (its fused kernels in interpret mode,
VISFD_FUSED_EIGEN=1) and ``visfd_tpu_torch.cli.filter_mrc.run(...,
device="cpu")`` (the kernels' plain twins), then the two output MRCs
compared.

Dense voting (``-tv-best 1.0``: every voxel votes) on ``-membrane``
must agree on every voxel to the TV tolerance, rtol 2e-4 and atol 2e-5
of the largest output magnitude.  ``-curve`` votes along the Hessian's
principal eigenvector, and on this phantom a few voxels have two
principal eigenvalues within 1e-3 of each other (relative to the
largest): there the float32 rounding of the blur (~1e-7) turns the
direction by up to ~1e-2 rad, and the curve votes around such a source
move by a few percent.  The curve case therefore checks, every voxel
each time:

* the port's voting and vote eigen score, fed the JAX CLI's own
  saliency and directions, reproduce the JAX output to the TV
  tolerance;
* the two packages' directions agree (|v.v'| >= 1 - 1e-6) wherever the
  relative eigen gap is at least 1e-3;
* every output voxel where the two CLIs differ lies within the vote
  window of a source whose gap is below 1e-3 and whose direction
  differs.

Under the default ``-tv-best 0.05`` both CLIs must reach the same
saliency threshold to rtol 1e-5; their outputs must then agree to the
TV tolerance on >= 99.9% of voxels, because a saliency within rounding
of the threshold may be kept by one package and dropped by the other,
which changes the votes around that source.
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import maximum_filter

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu.ops import eigen_pallas as jeigen
from visfd_tpu.ops import tv_pallas as jtv
from visfd_tpu.parallel import reduce as jreduce
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.ops import eigen_cuda as EC
from visfd_tpu_torch.ops.tv_cuda import tv_votes
from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.parallel.reduce import fraction_threshold
from visfd_tpu_torch.utils.phantom import membrane_phantom

SHAPE = (20, 28, 40)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    d = tmp_path_factory.mktemp("phantom")
    vol, dist = membrane_phantom(SHAPE, seed=3, thickness=2.5)
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mask = np.ones(SHAPE, np.float32)
    mask[:, :, :6] = 0.0
    mask[:3] = 2.0          # -mask-select 1 keeps only the 1s
    mrc.write_mrc(str(d / "mask.mrc"), mask)
    return d


def _run_both(d, args, monkeypatch):
    """Run both CLIs; returns (jax_out, torch_out, seen): ``seen`` holds
    the two thresholds, and each package's Hessian stage (input, score,
    direction) and the JAX voting call's arguments."""
    seen = {}

    def spy(name, fn, keep):
        def wrapped(*a, **k):
            r = fn(*a, **k)
            seen[name] = keep(a, k, r)
            return r
        return wrapped

    monkeypatch.setenv("VISFD_FUSED_EIGEN", "1")
    monkeypatch.setattr(jreduce, "fraction_threshold", spy(
        "thr_jax", jreduce.fraction_threshold, lambda a, k, r: r))
    monkeypatch.setattr(TFM, "fraction_threshold", spy(
        "thr_torch", TFM.fraction_threshold, lambda a, k, r: r))
    monkeypatch.setattr(jeigen, "hessian_principal_pallas", spy(
        "hess_jax", jeigen.hessian_principal_pallas,
        lambda a, k, r: [np.asarray(t) for t in (a[0],) + tuple(r)]))
    monkeypatch.setattr(TFM, "hessian_principal", spy(
        "hess_torch", TFM.hessian_principal,
        lambda a, k, r: [t.numpy().copy() for t in (a[0],) + tuple(r)]))
    monkeypatch.setattr(jtv, "tv_dense_stick_pallas", spy(
        "tv_jax", jtv.tv_dense_stick_pallas,
        lambda a, k, r: ([np.asarray(t) for t in a[:2]] + [a[2]], k)))
    base = ["-in", str(d / "in.mrc")] + args.split()
    assert JFM.run(base + ["-out", str(d / "jax.mrc")]) == 0
    assert TFM.run(base + ["-out", str(d / "torch.mrc")], device="cpu") == 0
    a = mrc.read_mrc(str(d / "jax.mrc"))
    b = mrc.read_mrc(str(d / "torch.mrc"))
    assert a.data.shape == b.data.shape == SHAPE
    assert a.header.cellA == pytest.approx(b.header.cellA)
    return a.data, b.data, seen


def _agree(a, b):
    return np.isclose(b, a, rtol=2e-4, atol=2e-5 * np.abs(a).max())


CASES = {
    "dense": "-w 1 -membrane minima 2.5 -tv 1.0 -tv-best 1.0",
    "mask": "-w 1 -membrane minima 2.5 -tv 1.0 -tv-best 1.0 "
            "-mask {d}/mask.mrc -mask-select 1",
    "autobin": "-w 1 -membrane minima 4 -tv 1.0 -tv-best 1.0",
    "curve": "-w 1 -curve minima 2.5 -tv 1.0 -tv-best 1.0",
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_dense_matches_jax(phantom, monkeypatch, case):
    a, b, seen = _run_both(phantom, CASES[case].format(d=phantom),
                           monkeypatch)
    assert np.isfinite(b).all()
    ok = _agree(a, b)
    if case == "curve":
        _curve_disagreement_is_ill_conditioned(a, ok, seen)
    else:
        assert ok.all(), f"{(~ok).sum()} voxels disagree"


def _curve_disagreement_is_ill_conditioned(a, ok, seen):
    """The curve case's three checks (module docstring)."""
    (sal, dir_j, tv_sigma), kw = seen["tv_jax"]
    vote, _ = tv_votes(torch.as_tensor(sal), torch.as_tensor(dir_j),
                       tv_sigma, exponent=kw["exponent"], detect_curves=True,
                       truncate_ratio=kw["truncate_ratio"],
                       channel_major=True, nvec_channel_major=True)
    score, _ = EC.sym3_score(vote, decreasing=True, formula="linear")
    witness = _agree(a, score.numpy())
    assert witness.all(), f"{(~witness).sum()} voxels disagree"

    blur, _, v_j = seen["hess_jax"]
    _, _, v_t = seen["hess_torch"]
    vals = EC.hessian_principal_plain(torch.as_tensor(blur), 2.5,
                                      formula="vals", want_v=False).numpy()
    gap = np.abs(vals[0] - vals[1]) / np.abs(vals).max()
    turned = np.abs((v_j * v_t).sum(0)) < 1 - 1e-6
    assert not (turned & (gap >= 1e-3)).any()
    hw = int(np.floor(tv_sigma * kw["truncate_ratio"]))
    near = maximum_filter(turned & (gap < 1e-3) & (sal != 0),
                          size=2 * hw + 1, mode="constant")
    assert near[~ok].all(), \
        f"{(~ok & ~near).sum()} voxels disagree away from a turned source"


def test_cli_sparse_matches_jax(phantom, monkeypatch):
    a, b, seen = _run_both(
        phantom, "-w 1 -membrane minima 2.5 -tv 1.0 -tv-angle-exponent 4",
        monkeypatch)
    assert seen["thr_torch"] == pytest.approx(seen["thr_jax"], rel=1e-5)
    assert _agree(a, b).mean() >= 0.999


@pytest.mark.parametrize("masked", [False, True])
def test_fraction_threshold_bit_identical(masked):
    rng = np.random.default_rng(4)
    score = rng.normal(size=(9, 13, 17)).astype(np.float32)
    score[0, :5] = 0.5      # duplicates
    mask = (rng.uniform(size=score.shape) > 0.4).astype(np.float32)
    m = mask if masked else None
    for frac in (0.0, 0.05, 0.5, 1.0):
        want = jreduce.fraction_threshold(score, frac, mask=m)
        got = fraction_threshold(torch.as_tensor(score), frac,
                                 mask=None if m is None
                                 else torch.as_tensor(m))
        vals = score[mask != 0] if masked else score.ravel()
        k = min(int(np.floor(vals.size * frac)), vals.size - 1)
        assert got == want == np.sort(vals)[::-1][k]


@pytest.mark.parametrize("flag", ["-gaus 2", "-coords c.txt"])
def test_cli_names_unhandled_flags(phantom, flag):
    """What the port refuses names itself: a misspelt flag and another
    tool's flag."""
    argv = (f"-in {phantom}/in.mrc -w 1 -membrane minima 2.5 -tv 1.0 "
            f"{flag}").split()
    with pytest.raises(InputError, match=flag.split()[0]):
        TFM.run(argv, device="cpu")


def test_cli_refuses_thin_volumes(tmp_path):
    mrc.write_mrc(str(tmp_path / "thin.mrc"), np.zeros((2, 8, 8), np.float32))
    with pytest.raises(InputError, match="at least 3 voxels"):
        TFM.run(f"-in {tmp_path}/thin.mrc -w 1 -membrane minima 2 -tv 1"
                .split(), device="cpu")
