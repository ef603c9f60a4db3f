"""The port's sharded phase checkpoint (``io/checkpoint``) and its CLI
flags, ``-save-progress-sharded`` / ``-load-progress-sharded``, on the
CPU, on the (20, 28, 40) phantom of ``tests/test_torch_cli_connect.py``.

* The library: a tensor and ShardedVolumes on (1, 1), (2, 2) and (4, 2)
  CPU meshes saved, each loaded into every partition and into none, bit
  for bit; each block file holds its own rows; a save replaces an older
  checkpoint whole; a haloed volume is refused, and so is a checkpoint
  whose blocks do not tile a target block.
* Against JAX: the JAX CLI's orbax checkpoint of the same command (read
  with ``visfd_tpu.io.checkpoint.load_sharded``; channel-last) and the
  port's: ``vote`` to atol 5e-6 of the largest (the ``.rec`` test's
  tolerance), ``saliency`` to rtol 2e-4 / atol 2e-5 of the largest (the
  TV tolerance), ``direction`` up to sign where the Hessian's principal
  eigenvalue is separated (as ``tests/test_torch_eigen.py``).  Both
  CLIs resume ``-connect`` from the JAX vote written as a port
  checkpoint: equal labels.
* Against the ``.rec`` path: ``-load-progress-sharded`` gives the
  output of ``-load-progress`` of the same save bit for bit, saved and
  loaded with and without ``-mesh 4``.
* The refusals (``InputError``): a volume of another shape (both shapes
  named), a directory without ``metadata.json``, an unfinished
  ``P.partial``, a target that is not a checkpoint.  ``-tv 0`` saves
  nothing.
"""

import json
import os

import numpy as np
import pytest
import torch

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu.io import checkpoint as JCK
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.cli import settings as S
from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.io import checkpoint as CK
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.ops import eigen_cuda as EC
from visfd_tpu_torch.ops import filters as F
from visfd_tpu_torch.parallel.mesh import (
    ShardedVolume, make_mesh, shard)
from visfd_tpu_torch.parallel.gather import to_host_np
from visfd_tpu_torch.utils.phantom import membrane_phantom
from visfd_tpu_torch.utils.progress import Report

SHAPE = (20, 28, 40)
MEMBRANE = "-w 1 -membrane minima 2.5 -tv 1.0 -tv-angle-exponent 4"
CPU = ["cpu"] * 8
GRIDS = {"tensor": None, "1x1": 1, "2x2": 4, "4x2": 8}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    vol, _ = membrane_phantom(SHAPE, seed=3, thickness=2.5)
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    odd, _ = membrane_phantom((21, 28, 40), seed=4, thickness=2.5)
    mrc.write_mrc(str(d / "odd.mrc"), odd.numpy())
    return d


def _img(path):
    return mrc.read_mrc(str(path)).data


def _run(argv, mesh=True):
    """The port's CLI on the CPU (``-mesh N`` over CPU blocks)."""
    return TFM.run(argv.split(), device="cpu", report=Report(None),
                   mesh_devices=CPU if mesh else None)


def _arrays():
    rng = np.random.default_rng(12)
    return {"vote": rng.normal(size=(6,) + SHAPE).astype(np.float32),
            "saliency": rng.normal(size=SHAPE).astype(np.float32),
            "direction": rng.normal(size=(3,) + SHAPE).astype(np.float32)}


def _partition(arrays, grid):
    """The arrays as whole tensors or split over a CPU mesh of ``grid``
    blocks."""
    if GRIDS[grid] is None:
        return {k: torch.tensor(v) for k, v in arrays.items()}
    mesh = make_mesh(GRIDS[grid], devices=CPU)
    return {k: shard(v, mesh, lead=v.ndim - 3) for k, v in arrays.items()}


@pytest.mark.parametrize("load", list(GRIDS))
@pytest.mark.parametrize("save", list(GRIDS))
def test_round_trip_onto_any_partition(tmp_path, save, load):
    arrays = _arrays()
    p = tmp_path / "ck"
    nbytes = CK.save_sharded(str(p), _partition(arrays, save))
    assert nbytes == sum(v.nbytes for v in arrays.values())
    meta = json.load(open(p / "metadata.json"))
    assert meta["format"] == CK.FORMAT
    n_blocks = GRIDS[save] or 1
    for name, want in arrays.items():
        entry = meta["arrays"][name]
        assert entry["shape"] == list(want.shape)
        assert entry["dtype"] == "float32" and len(entry["blocks"]) == n_blocks
        for blk in entry["blocks"]:
            (z0, z1), (y0, y1) = blk["z"], blk["y"]
            np.testing.assert_array_equal(np.load(p / blk["file"]),
                                          want[..., z0:z1, y0:y1, :])
    assert sorted(os.listdir(tmp_path)) == ["ck"]     # no .partial left
    like = (None if GRIDS[load] is None
            else make_mesh(GRIDS[load], devices=CPU))
    got = CK.load_sharded(str(p), like=like, device="cpu")
    assert sorted(got) == sorted(arrays)
    for name, want in arrays.items():
        assert isinstance(got[name], ShardedVolume) == (like is not None)
        if like is not None:
            assert got[name].mesh == like
        np.testing.assert_array_equal(to_host_np(got[name]), want)


def test_load_onto_a_volume_and_by_name(tmp_path):
    """``like`` may be a ShardedVolume (its mesh and shape); ``names``
    picks arrays; a save replaces an older checkpoint whole."""
    arrays = _arrays()
    p = str(tmp_path / "ck")
    CK.save_sharded(p, {"vote": torch.zeros(2, 4, 4, 4)})
    CK.save_sharded(p, _partition(arrays, "2x2"))
    like = shard(np.zeros(SHAPE, np.float32), make_mesh(8, devices=CPU))
    got = CK.load_sharded(p, like=like, names=("saliency",))
    assert list(got) == ["saliency"] and got["saliency"].mesh == like.mesh
    np.testing.assert_array_equal(to_host_np(got["saliency"]),
                                  arrays["saliency"])
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    with pytest.raises(InputError, match="holds no array"):
        CK.load_sharded(p, names=("nothing",), device="cpu")


def test_a_haloed_volume_is_refused(tmp_path):
    v = shard(np.zeros(SHAPE, np.float32), make_mesh(4, devices=CPU))
    haloed = ShardedVolume(v.blocks, v.mesh, v.shape, halo=(1, 0))
    with pytest.raises(ValueError, match="halos"):
        CK.save_sharded(str(tmp_path / "ck"), {"saliency": haloed})


def test_a_block_missing_from_the_metadata_is_refused(tmp_path):
    p = tmp_path / "ck"
    CK.save_sharded(str(p), _partition(_arrays(), "2x2"))
    meta = json.load(open(p / "metadata.json"))
    meta["arrays"]["vote"]["blocks"].pop()
    json.dump(meta, open(p / "metadata.json", "w"))
    with pytest.raises(InputError, match='"vote" do not tile'):
        CK.load_sharded(str(p), device="cpu")


def test_a_volume_of_another_shape_is_refused(phantom, saves, tmp_path):
    with pytest.raises(InputError, match=r"\(20, 28, 40\).*\(21, 28, 40\)"):
        _run(f"-in {phantom}/odd.mrc -out {tmp_path}/x.mrc {MEMBRANE} "
             f"-load-progress-sharded {saves['one']}_ck")


def test_a_directory_without_metadata_is_refused(phantom, tmp_path):
    os.makedirs(tmp_path / "empty")
    with pytest.raises(InputError, match="no metadata.json"):
        _run(f"-in {phantom}/in.mrc -out {tmp_path}/x.mrc {MEMBRANE} "
             f"-load-progress-sharded {tmp_path}/empty")


def test_an_unfinished_save_is_refused(tmp_path):
    """P.partial itself, or P beside a stale P.partial, raise; the next
    save replaces the stale P.partial."""
    os.makedirs(tmp_path / "cut.partial")
    with pytest.raises(InputError, match="unfinished save"):
        CK.load_sharded(str(tmp_path / "cut.partial"), device="cpu")
    with pytest.raises(InputError, match="cut.partial.*unfinished save"):
        CK.load_sharded(str(tmp_path / "cut"), device="cpu")
    CK.save_sharded(str(tmp_path / "cut"), {"vote": torch.ones(1, 3, 3, 3)})
    assert os.listdir(tmp_path) == ["cut"]


def test_a_target_that_is_not_a_checkpoint_is_kept(phantom, tmp_path):
    os.makedirs(tmp_path / "data")
    (tmp_path / "data" / "keep.txt").write_text("x")
    with pytest.raises(InputError, match="not a .* checkpoint"):
        _run(f"-in {phantom}/in.mrc -out {tmp_path}/x.mrc {MEMBRANE} "
             f"-save-progress-sharded {tmp_path}/data")
    assert os.listdir(tmp_path / "data") == ["keep.txt"]
    assert not os.path.exists(tmp_path / "data.partial")


def test_a_sibling_named_like_the_old_checkpoint_survives(tmp_path):
    """Replacing P removes P alone: a user directory beside it, named
    P.old, keeps its files."""
    p = str(tmp_path / "ck")
    CK.save_sharded(p, {"vote": torch.zeros(1, 3, 3, 3)})
    os.makedirs(tmp_path / "ck.old")
    (tmp_path / "ck.old" / "keep.txt").write_text("x")
    CK.save_sharded(p, {"vote": torch.ones(1, 3, 3, 3)})
    assert sorted(os.listdir(tmp_path)) == ["ck", "ck.old"]
    assert os.listdir(tmp_path / "ck.old") == ["keep.txt"]
    np.testing.assert_array_equal(
        CK.load_sharded(p, device="cpu")["vote"].numpy(), 1.0)


def test_tv_0_saves_nothing(phantom, tmp_path):
    assert _run(f"-in {phantom}/in.mrc -out {tmp_path}/o.mrc -w 1 "
                f"-membrane minima 2.5 -tv 0 -save-progress-sharded "
                f"{tmp_path}/ck") == 0
    assert os.listdir(tmp_path) == ["o.mrc"]


@pytest.fixture(scope="module")
def saves(phantom):
    """The port's command saved both ways (``.rec`` and checkpoint),
    without and with ``-mesh 4``: {tag: base path}."""
    d = phantom
    out = {}
    for tag, extra in (("one", ""), ("mesh", " -mesh 4")):
        base = f"{d}/sv_{tag}"
        assert _run(f"-in {d}/in.mrc -out {base}.mrc {MEMBRANE} "
                    f"-save-progress {base} -save-progress-sharded "
                    f"{base}_ck{extra}") == 0
        out[tag] = base
    return out


@pytest.mark.parametrize("saved,loaded", [("one", "one"), ("mesh", "mesh"),
                                          ("mesh", "one"), ("one", "mesh")])
def test_sharded_load_equals_rec_load(phantom, saves, saved, loaded):
    d, base = phantom, saves[saved]
    extra = " -mesh 4" if loaded == "mesh" else ""
    outs = []
    for flag in (f"-load-progress {base}", f"-load-progress-sharded "
                                           f"{base}_ck"):
        o = f"{d}/ld_{saved}_{loaded}_{len(outs)}.mrc"
        assert _run(f"-in {d}/in.mrc -out {o} {MEMBRANE} {flag}{extra}") == 0
        outs.append(_img(o))
    assert np.abs(outs[0]).max() > 0
    np.testing.assert_array_equal(outs[1], outs[0])


def test_save_keeps_the_runs_partition(saves):
    """The checkpoint of a ``-mesh 4`` run holds its (2, 2) blocks; both
    hold the same arrays, and the vote the ``.rec`` files' channels."""
    for tag, n in (("one", 1), ("mesh", 4)):
        meta = json.load(open(f"{saves[tag]}_ck/metadata.json"))
        assert {k: len(v["blocks"]) for k, v in meta["arrays"].items()} == \
            {"vote": n, "saliency": n, "direction": n}
    vote = CK.load_sharded(f"{saves['mesh']}_ck", device="cpu")["vote"]
    for ch in range(6):
        np.testing.assert_array_equal(
            vote[ch].numpy(), _img(f"{saves['mesh']}_tensor_{ch}.rec"))


def _jax_and_port_checkpoints(d, monkeypatch):
    """The JAX CLI's and the port's checkpoint of MEMBRANE: (the JAX
    arrays, channel-last, as numpy; the port's, channel-major)."""
    monkeypatch.setenv("VISFD_FUSED_EIGEN", "1")
    if not os.path.exists(f"{d}/ck_jax"):
        assert JFM.run(f"-in {d}/in.mrc -out {d}/ck_jax.mrc {MEMBRANE} "
                       f"-save-progress-sharded {d}/ck_jax".split()) == 0
        assert _run(f"-in {d}/in.mrc -out {d}/ck_torch.mrc {MEMBRANE} "
                    f"-save-progress-sharded {d}/ck_torch") == 0
    want = {k: np.asarray(v)
            for k, v in JCK.load_sharded(f"{d}/ck_jax").items()}
    got = {k: v.numpy() for k, v in
           CK.load_sharded(f"{d}/ck_torch", device="cpu").items()}
    return want, got


def test_checkpoint_matches_jax(phantom, monkeypatch):
    want, got = _jax_and_port_checkpoints(phantom, monkeypatch)
    assert sorted(got) == sorted(want) == ["direction", "saliency", "vote"]
    vote = np.moveaxis(want["vote"], -1, 0)
    np.testing.assert_allclose(got["vote"], vote,
                               atol=5e-6 * np.abs(vote).max())
    sal = want["saliency"]
    assert np.abs(sal).max() > 0
    np.testing.assert_allclose(got["saliency"], sal, rtol=2e-4,
                               atol=2e-5 * np.abs(sal).max())
    # direction: the Hessian's principal eigenvector, up to sign where
    # its eigenvalue is separated (the port's eigenvalues of the run)
    s = S.parse_args(f"-in x {MEMBRANE}".split())
    sigma, x = s.width_a[0], torch.tensor(_img(phantom / "in.mrc"))
    hw = max(1, int(np.floor(sigma * TFM._truncate_ratio(s))))
    vals, _ = EC.hessian_principal(
        F.apply_gauss(x, sigma, truncate_halfwidth=(hw,) * 3), sigma,
        decreasing=not s.ridges_are_maxima, formula="vals", want_v=False)
    vals = vals.numpy()
    gap = np.abs(vals[0] - vals[1])
    well = gap > 1e-3 * np.abs(vals).max()
    assert well.mean() > 0.95
    dot = np.abs((got["direction"] * np.moveaxis(want["direction"], -1, 0))
                 .sum(0))
    assert dot[well].min() > 1 - 1e-4


def test_resume_from_jax_vote_matches_jax(phantom, monkeypatch):
    """Both CLIs resume ``-connect`` from the JAX vote: the JAX CLI from
    its own checkpoint, the port from the same arrays saved as its
    checkpoint.  Equal labels."""
    d = phantom
    want, _ = _jax_and_port_checkpoints(d, monkeypatch)
    CK.save_sharded(f"{d}/ck_from_jax", {
        k: torch.tensor(np.ascontiguousarray(
            v if v.ndim == 3 else np.moveaxis(v, -1, 0)))
        for k, v in want.items()})
    thr = float(np.percentile(_img(d / "ck_torch.mrc"), 95))
    args = (f"-in {d}/in.mrc {MEMBRANE} -connect {thr:.6g} "
            f"-connect-angle 30")
    assert JFM.run(f"{args} -out {d}/rs_jax.mrc -load-progress-sharded "
                   f"{d}/ck_jax".split()) == 0
    assert _run(f"{args} -out {d}/rs_torch.mrc -load-progress-sharded "
                f"{d}/ck_from_jax", mesh=False) == 0
    a, b = _img(d / "rs_jax.mrc"), _img(d / "rs_torch.mrc")
    assert a.max() > 5
    np.testing.assert_array_equal(b, a)
