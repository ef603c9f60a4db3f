"""The PyTorch port's -mesh path (visfd_tpu_torch/parallel) against the
JAX package's sharded path and against the port on one device.

JAX runs its shard_map wrappers on the 8 host devices that
tests/conftest.py forces, as a (4, 2) mesh, its Pallas kernels in
interpret mode; the port builds the same (4, 2) mesh with
``make_mesh(8, devices=["cpu"] * 8)`` and runs the kernels' plain twins
on every block.  Inputs come from numpy seeds.

Tolerances:

* halo exchange, the blur, the FD Hessian, the voting with an even
  exponent and the radix threshold: exact (every voxel sums the same
  terms in the same order, sharded or not);
* the voting against JAX: the TV tolerance, rtol 2e-4 / atol 2e-5;
* the eigen stages: rtol 2e-5, atol 1e-6 of the largest score, and
  ``|v.v'| > 1 - 1e-4`` where the score is healthy
  (tests/test_parallel.py: the vectorised transcendentals may differ by
  an ulp with a voxel's lane, which depends on the block's shape);
* so the voting with an odd exponent (``pow``) and the whole CLI,
  sharded against unsharded on the CPU: rtol 1e-5, atol 1e-6 of the
  largest value (measured: at most 5.8e-11 against 0.024).  On the card
  the kernels compute per thread and the bar is bit equality
  (``chip_smoke.py`` phase 5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from visfd_tpu.cli import filter_mrc as JFM
from visfd_tpu.ops.eigen_pallas import sym3_score_pallas
from visfd_tpu.parallel import mesh as JM
from visfd_tpu.parallel import reduce as JR
from visfd_tpu.parallel import sharded as JSH
from visfd_tpu_torch.cli import filter_mrc as TFM
from visfd_tpu_torch.cli.settings import InputError
from visfd_tpu_torch.features import hessian as FH
from visfd_tpu_torch.io import mrc
from visfd_tpu_torch.ops import conv, eigen_cuda as EC
from visfd_tpu_torch.ops import filters as TF
from visfd_tpu_torch.ops.tv_cuda import tv_votes
from visfd_tpu_torch.parallel import reduce as TR
from visfd_tpu_torch.parallel import sharded as TSH
from visfd_tpu_torch.parallel.gather import is_writer, to_host_np
from visfd_tpu_torch.parallel.halo import halo_pad, halo_pad_2d
from visfd_tpu_torch.parallel.mesh import Mesh, make_mesh, shard
from visfd_tpu_torch.utils.phantom import membrane_phantom
from visfd_tpu_torch.utils.progress import Report

RATIO = float(np.sqrt(2.0))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return JM.make_mesh(8)


def _jshard(a, jmesh, lead=0):
    spec = (None,) * lead + tuple(jmesh.axis_names)
    return jax.device_put(jnp.asarray(a), NamedSharding(jmesh, P(*spec)))


def _eigen_close(got_s, got_v, want_s, want_v):
    np.testing.assert_allclose(got_s, want_s, rtol=2e-5,
                               atol=np.abs(want_s).max() * 1e-6)
    well = want_s > np.abs(want_s).max() * 1e-3
    dot = np.abs((got_v * want_v).sum(0))
    assert dot[well].min() > 1 - 1e-4


# --- mesh, shard, gather ---------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax_factorization(n, jmesh):
    m = make_mesh(n, devices=["cpu"] * 8)
    assert m.shape == JM.make_mesh(n).devices.shape
    assert m.axis_names == tuple(jmesh.axis_names) == ("z", "y")


def test_make_mesh_needs_a_card_unless_devices_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(4)
    assert make_mesh(4, devices=["cpu"]).shape == (1, 1)  # at most 1 here


def test_shard_round_trip_and_uneven(tmesh):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 8, 6, 5)).astype(np.float32)
    for lead, a in ((0, x[0]), (1, x)):
        vol = shard(a, tmesh, lead=lead)
        assert vol.shape == a.shape and vol.block_shape == (2, 3)
        np.testing.assert_array_equal(to_host_np(vol), a)
        np.testing.assert_array_equal(
            to_host_np(shard(torch.as_tensor(a), tmesh, lead=lead)), a)
    with pytest.raises(ValueError, match="not divisible"):
        shard(x[0, :7], tmesh)
    assert is_writer()


# --- halo exchange ---------------------------------------------------------

@pytest.mark.parametrize("shape,hz,hy", [
    ((8, 6, 5), 1, 1),       # blocks (2, 3)
    ((8, 6, 5), 3, 2),       # multi-hop along z: block 2, halo 3
    ((4, 4, 3), 3, 5),       # blocks (1, 2): 3 and 3 hops
])
def test_halo_pad_2d_matches_zero_padded_slices(tmesh, shape, hz, hy):
    """Each haloed block equals the slice of the zero-padded volume
    around it, corners included; channel-major volumes too."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2,) + shape).astype(np.float32)
    for lead, a in ((0, x[0]), (1, x)):
        pad = [(0, 0)] * lead + [(hz, hz), (hy, hy), (0, 0)]
        full = np.pad(a, pad)
        vol = halo_pad_2d(shard(a, tmesh, lead=lead), hz, hy)
        assert vol.halo == (hz, hy)
        bz, by = vol.block_shape
        pre = (slice(None),) * lead
        for iz, iy, b in vol.cells():
            want = full[pre + (slice(iz * bz, iz * bz + bz + 2 * hz),
                               slice(iy * by, iy * by + by + 2 * hy))]
            np.testing.assert_array_equal(b.numpy(), want)


def test_halo_pad_one_axis(tmesh):
    a = np.arange(8 * 6 * 3, dtype=np.float32).reshape(8, 6, 3)
    vol = halo_pad(shard(a, tmesh), 3, 0)
    full = np.pad(a, [(3, 3), (0, 0), (0, 0)])
    for iz, iy, b in vol.cells():
        np.testing.assert_array_equal(
            b.numpy(), full[iz * 2:iz * 2 + 8, iy * 3:iy * 3 + 3])
    assert halo_pad(vol, 0, 1) is vol


# --- the sharded blur ------------------------------------------------------

@pytest.mark.parametrize("form", ["nomask", "masked", "raw", "raw_masked"])
def test_sharded_blur_equals_single_device(tmesh, form):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(12, 10, 9)).astype(np.float32)   # blocks (3, 5)
    m = (rng.uniform(size=x.shape) > 0.3).astype(np.float32)
    ks = [rng.uniform(0.1, 1.0, size=n).astype(np.float32) for n in (5, 3, 9)]
    masked, normalize = "masked" in form, not form.startswith("raw")
    mask = torch.as_tensor(m) if masked else None
    want = conv.separable_conv3d(torch.as_tensor(x), ks, mask=mask,
                                 normalize=normalize)
    got = TSH.separable_conv3d_sharded(
        shard(x, tmesh), ks, mask=shard(m, tmesh) if masked else None,
        normalize=normalize)
    np.testing.assert_array_equal(to_host_np(got), want.numpy())


def test_apply_gauss_dispatches_on_sharded(tmesh):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 8, 7)).astype(np.float32)
    want = TF.apply_gauss(torch.as_tensor(x), 1.5)
    got = TF.apply_gauss(shard(x, tmesh), 1.5)
    np.testing.assert_array_equal(to_host_np(got), want.numpy())


# --- Hessian + eigensolve per shard ----------------------------------------

def test_hessian_principal_sharded_matches_jax(tmesh, jmesh):
    x = np.random.default_rng(4).normal(size=(16, 24, 33)).astype(np.float32)
    js, jv = JSH.hessian_principal_sharded(_jshard(x, jmesh), jmesh, 2.0,
                                           want_v=True, interpret=True)
    ts, tv = TSH.hessian_principal_sharded(shard(x, tmesh), 2.0, want_v=True)
    _eigen_close(to_host_np(ts), to_host_np(tv), np.asarray(js),
                 np.asarray(jv))


@pytest.mark.parametrize("shape,grid", [((16, 24, 33), (4, 2)),
                                        ((4, 6, 9), (4, 2)),
                                        ((6, 4, 5), (1, 4)),
                                        ((3, 3, 4), (3, 3))])
@pytest.mark.parametrize("formula", ["planar", "linear", "vals"])
def test_hessian_principal_sharded_matches_single(shape, grid, formula):
    """Blocks (4, 12), (1, 3), (6, 1) and (1, 1): the thin ones take
    their face rows from the next block."""
    cpu = torch.device("cpu")
    mesh = Mesh(tuple((cpu,) * grid[1] for _ in range(grid[0])))
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    ws, wv = EC.hessian_principal(torch.as_tensor(x), 1.7, formula=formula)
    gs, gv = TSH.hessian_principal_sharded(shard(x, mesh), 1.7,
                                           formula=formula)
    if formula == "vals":
        np.testing.assert_allclose(to_host_np(gs), ws.numpy(), rtol=2e-5,
                                   atol=np.abs(ws.numpy()).max() * 1e-6)
    else:
        _eigen_close(to_host_np(gs), to_host_np(gv), ws.numpy(), wv.numpy())


@pytest.mark.parametrize("formula,decreasing", [("linear", False),
                                                ("vals", True)])
def test_hessian_principal_sharded_thin_blocks_match_jax(tmesh, jmesh,
                                                         formula, decreasing):
    """Blocks (2, 3) on the (4, 2) mesh: the per-shard entry (each block
    in place, face-sized halo slabs) against JAX's padded blocks."""
    x = np.random.default_rng(14).normal(size=(8, 6, 17)).astype(np.float32)
    js, jv = JSH.hessian_principal_sharded(
        _jshard(x, jmesh), jmesh, 1.5, decreasing=decreasing,
        formula=formula, want_v=True, interpret=True)
    ts, tv = TSH.hessian_principal_sharded(shard(x, tmesh), 1.5,
                                           decreasing=decreasing,
                                           formula=formula, want_v=True)
    if formula == "vals":
        want = np.asarray(js)
        np.testing.assert_allclose(to_host_np(ts), want, rtol=2e-5,
                                   atol=np.abs(want).max() * 1e-6)
        return
    _eigen_close(to_host_np(ts), to_host_np(tv), np.asarray(js),
                 np.asarray(jv))


@pytest.mark.parametrize("shape,grid", [((8, 6, 5), (4, 2)),
                                        ((3, 3, 4), (3, 3)),
                                        ((6, 4, 3), (2, 4))])
def test_face_halos_match_zero_padded_slices(shape, grid):
    """Blocks (2, 3), (1, 1) and (3, 1): each slab equals the slice of
    the volume zero-padded in z and y, y-corner rows included, and the y
    halos are views of the neighbouring blocks."""
    from visfd_tpu_torch.parallel.halo import face_halos
    cpu = torch.device("cpu")
    mesh = Mesh(tuple((cpu,) * grid[1] for _ in range(grid[0])))
    a = np.random.default_rng(15).normal(size=shape).astype(np.float32)
    p = np.pad(a, [(1, 1), (1, 1), (0, 0)])
    vol = shard(a, mesh)
    bz, by = vol.block_shape
    for iz, iy, b in vol.cells():
        z, y = iz * bz + 1, iy * by + 1
        got = face_halos(vol, iz, iy)
        want = (p[z - 1, y - 1:y + by + 1], p[z + bz, y - 1:y + by + 1],
                p[z:z + bz, y - 1], p[z:z + bz, y + by])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
        if iy > 0:
            assert got[2].data_ptr() == vol.blocks[iz][iy - 1][:, -1].data_ptr()


def test_hessian_sharded_copies_no_block(monkeypatch):
    """The sharded Hessian hands each block itself to the per-shard
    entry, with face-sized halo slabs, and no ``cat`` or ``pad`` it makes
    is larger than a halo plane."""
    cpu = torch.device("cpu")
    mesh = Mesh(((cpu,) * 2,) * 2)
    x = np.random.default_rng(16).normal(size=(8, 10, 7)).astype(np.float32)
    vol = shard(x, mesh)
    bz, by = vol.block_shape
    plane = (by + 2) * x.shape[2]
    made, seen = [], []

    def recording(fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            made.append(out.numel())
            return out
        return wrapped

    def block_entry(block, z_lo, z_hi, y_lo, y_hi, sigma, decreasing,
                    formula, want_v):
        seen.append((block, [t.numel() for t in (z_lo, z_hi, y_lo, y_hi)]))
        return torch.zeros((4,) + tuple(block.shape))

    monkeypatch.setattr(torch, "cat", recording(torch.cat))
    monkeypatch.setattr(torch.nn.functional, "pad",
                        recording(torch.nn.functional.pad))
    monkeypatch.setattr(TSH, "hessian_principal_block", block_entry)
    TSH.hessian_principal_sharded(vol, 1.5)
    blocks = [b for _, _, b in vol.cells()]
    assert len(seen) == len(blocks)
    for (b, sizes), want in zip(seen, blocks):
        assert b is want
        assert sizes == [plane, plane, bz * x.shape[2], bz * x.shape[2]]
    assert made and max(made) <= plane


def test_hessian_prepadded_twin_and_clamp_faces():
    """On a zero-padded volume with its faces clamped, the per-shard FD
    Hessian is the single-device one exactly, and the per-shard twin
    agrees with the single-device twin."""
    x = torch.as_tensor(
        np.random.default_rng(6).normal(size=(5, 7, 9)).astype(np.float32))
    xp = torch.nn.functional.pad(x, (1,) * 6)
    np.testing.assert_array_equal(
        EC.clamp_faces(FH.hessian_fd_padded(xp).movedim(-1, 0)).numpy(),
        FH.hessian_fd(x).movedim(-1, 0).numpy())
    raw = EC.clamp_faces(EC.hessian_principal_prepadded(xp, 1.3))
    want = EC.hessian_principal_plain(x, 1.3)
    _eigen_close(raw[0].numpy(), raw[1:].numpy(), want[0].numpy(),
                 want[1:].numpy())


# --- voting per shard ------------------------------------------------------

def _tv_fields(seed, shape):
    rng = np.random.default_rng(seed)
    sal = rng.uniform(0, 1, size=shape).astype(np.float32)
    sal[sal < 0.4] = 0.0
    v = rng.normal(size=(3,) + shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    mask = (rng.uniform(size=shape) > 0.25).astype(np.float32)
    return sal, v, mask


def test_tv_accumulate_sharded_matches_jax(tmesh, jmesh):
    """n = 24, sigma 1.5, dense, masked with the denominator,
    channel-major in and out."""
    sal, v, mask = _tv_fields(7, (24, 24, 24))
    jd, jden = JSH.tv_accumulate_sharded_pallas(
        _jshard(sal, jmesh), _jshard(v, jmesh, lead=1), _jshard(mask, jmesh),
        1.5, 4, False, RATIO, True, jmesh, interpret=True,
        channel_major=True, nvec_channel_major=True)
    td, tden = TSH.tv_accumulate_sharded(
        shard(sal, tmesh), shard(v, tmesh, lead=1), shard(mask, tmesh), 1.5,
        4, False, RATIO, True)
    for got, want in ((td, jd), (tden, jden)):
        np.testing.assert_allclose(to_host_np(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["dense", "mask_den", "curves_e3",
                                  "multihop"])
def test_tv_accumulate_sharded_equals_single(tmesh, case):
    """Bit for bit, as the JAX package asserts of its own (the odd
    exponent to rtol 1e-6: the twin's ``pow`` is vectorised); "multihop"
    has blocks (2, 6) under a halfwidth-3 window."""
    shape, sigma, ratio, e, curves, masked = {
        "dense": ((24, 24, 24), 1.5, RATIO, 4, False, False),
        "mask_den": ((16, 12, 11), 1.5, RATIO, 4, False, True),
        "curves_e3": ((12, 10, 13), 1.5, RATIO, 3, True, False),
        "multihop": ((8, 12, 10), 1.5, 2.5, 4, False, True),
    }[case]
    sal, v, mask = _tv_fields(8, shape)
    m = torch.as_tensor(mask) if masked else None
    want, want_den = tv_votes(torch.as_tensor(sal), torch.as_tensor(v), sigma,
                              exponent=e, mask_src=m, detect_curves=curves,
                              truncate_ratio=ratio, want_denominator=masked,
                              channel_major=True, nvec_channel_major=True)
    got, got_den = TSH.tv_accumulate_sharded(
        shard(sal, tmesh), shard(v, tmesh, lead=1),
        shard(mask, tmesh) if masked else None, sigma, e, curves, ratio,
        masked, sparse=True)
    if e % 2:
        np.testing.assert_allclose(to_host_np(got), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
    else:
        np.testing.assert_array_equal(to_host_np(got), want.numpy())
    if masked:
        np.testing.assert_array_equal(to_host_np(got_den), want_den.numpy())
    else:
        assert got_den is None


# --- vote-tensor score per shard -------------------------------------------

def test_sym3_score_sharded_matches_jax_and_single(tmesh, jmesh):
    rng = np.random.default_rng(9)
    t6 = rng.normal(size=(6, 16, 16, 16)).astype(np.float32)
    js, jv = JSH.sym3_score_sharded(_jshard(t6, jmesh, lead=1), jmesh,
                                    formula="stick", want_v=True,
                                    interpret=True)
    ts, tv = TSH.sym3_score_sharded(shard(t6, tmesh, lead=1),
                                    formula="stick", want_v=True)
    ws, wv = EC.sym3_score(torch.as_tensor(t6), formula="stick", want_v=True)
    for want_s, want_v in ((np.asarray(js), np.asarray(jv)),
                           (ws.numpy(), wv.numpy())):
        _eigen_close(to_host_np(ts), to_host_np(tv), want_s, want_v)
    # the unsharded JAX kernel agrees as well
    ps, _ = sym3_score_pallas(jnp.asarray(t6), formula="stick",
                              interpret=True)
    np.testing.assert_allclose(to_host_np(ts), np.asarray(ps), rtol=2e-5,
                               atol=np.abs(np.asarray(ps)).max() * 1e-6)


# --- the -tv-best threshold over blocks ------------------------------------

def _scores(seed):
    rng = np.random.default_rng(seed)
    score = rng.normal(size=(8, 6, 7)).astype(np.float32)
    score[0, :3] = 0.5                       # ties
    score[1, :2] = -0.0                      # signed zeros
    score[2, :2] = 0.0
    score[3] = -np.abs(score[3])             # negatives
    mask = (rng.uniform(size=score.shape) > 0.4).astype(np.float32)
    return score, mask


@pytest.mark.parametrize("masked", [False, True])
def test_kth_largest_and_count_valid_exact(tmesh, jmesh, masked):
    score, mask = _scores(10)
    m = mask if masked else None
    vals = score[mask != 0] if masked else score.ravel()
    sv = shard(score, tmesh)
    mv = shard(mask, tmesh) if masked else None
    assert TR.count_valid(sv, mv) == vals.size == JR.count_valid(
        jnp.asarray(score), jmesh, None if m is None else jnp.asarray(m))
    want_sorted = np.sort(vals)[::-1]
    for k in (0, 1, 5, vals.size // 2, vals.size - 1):
        got = TR.kth_largest(sv, k, mv)
        jax_k = np.float32(JR.kth_largest(
            jnp.asarray(score), k, jmesh,
            None if m is None else jnp.asarray(m)))
        assert got == want_sorted[k]
        assert np.float32(got).view(np.int32) == jax_k.view(np.int32)


@pytest.mark.parametrize("masked", [False, True])
def test_fraction_threshold_mesh_exact(tmesh, jmesh, masked):
    score, mask = _scores(11)
    m = mask if masked else None
    vals = score[mask != 0] if masked else score.ravel()
    for frac in (0.0, 0.05, 0.5, 1.0):
        k = min(int(np.floor(vals.size * frac)), vals.size - 1)
        single = TR.fraction_threshold(
            torch.as_tensor(score), frac,
            mask=None if m is None else torch.as_tensor(m))
        by_mesh = TR.fraction_threshold(
            torch.as_tensor(score), frac, mesh=tmesh,
            mask=None if m is None else torch.as_tensor(m))
        sharded = TR.fraction_threshold(
            shard(score, tmesh), frac,
            mask=None if m is None else shard(m, tmesh))
        want = JR.fraction_threshold(score, frac, mesh=jmesh, mask=m)
        assert single == by_mesh == sharded == want == np.sort(vals)[::-1][k]


def test_global_min_max_mean(tmesh):
    score, mask = _scores(12)
    vals = score[mask != 0]
    vmin, vmax, vmean = TR.global_min_max_mean(shard(score, tmesh),
                                               shard(mask, tmesh))
    assert (vmin, vmax) == (vals.min(), vals.max())
    assert vmean == pytest.approx(vals.astype(np.float64).mean(), rel=1e-12)
    assert TR.global_min_max_mean(torch.as_tensor(score))[:2] == (
        score.min(), score.max())


# --- the CLI ---------------------------------------------------------------

SHAPE = (20, 28, 40)   # blocks (5, 14) on the (4, 2) mesh


@pytest.fixture(scope="module")
def phantom(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_phantom")
    vol, _ = membrane_phantom(SHAPE, seed=3, thickness=2.5)
    mrc.write_mrc(str(d / "in.mrc"), vol.numpy())
    mask = np.ones(SHAPE, np.float32)
    mask[:, :, :6] = 0.0
    mrc.write_mrc(str(d / "mask.mrc"), mask)
    odd, _ = membrane_phantom((21, 28, 40), seed=4, thickness=2.5)
    mrc.write_mrc(str(d / "odd.mrc"), odd.numpy())
    return d


def _torch_cli(d, args, name, mesh):
    out = d / f"{name}.mrc"
    rep = Report(None)
    argv = args.split() + ["-out", str(out)] + (["-mesh", "8"] if mesh
                                                 else [])
    assert TFM.run(argv, device="cpu", report=rep,
                   mesh_devices=["cpu"] * 8) == 0
    return mrc.read_mrc(str(out)).data, rep.paths


CLI_CASES = {
    "dense": "-w 1 -membrane minima 2.5 -tv 1.0 -tv-best 1.0",
    "mask": "-w 1 -membrane minima 2.5 -tv 1.0 -tv-best 1.0 "
            "-mask {d}/mask.mrc",
    "sparse": "-w 1 -membrane minima 2.5 -tv 1.0 -tv-angle-exponent 4",
    "curve_bg": "-w 1 -curve minima 2.5 -tv 1.0 -membrane-background 6",
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_mesh_equals_single_device(phantom, case):
    args = f"-in {phantom}/in.mrc " + CLI_CASES[case].format(d=phantom)
    single, paths1 = _torch_cli(phantom, args, f"{case}_1", mesh=False)
    meshed, paths8 = _torch_cli(phantom, args, f"{case}_8", mesh=True)
    assert paths1 == {k: "plain" for k in ("hessian_eigen", "tv",
                                           "vote_eigen")}
    assert paths8 == {k: "plain-sharded" for k in paths1}
    assert np.isfinite(meshed).all()
    np.testing.assert_allclose(meshed, single, rtol=1e-5,
                               atol=1e-6 * np.abs(single).max())


@pytest.mark.parametrize("case", ["dense", "mask", "sparse"])
def test_cli_mesh_matches_jax_mesh(phantom, monkeypatch, case):
    """The JAX CLI with -mesh 8 (its per-shard kernels in interpret
    mode) against the port's: every voxel to the TV tolerance for dense
    voting; under -tv-best 0.05 the same threshold and >= 99.9% of the
    voxels (as tests/test_torch_cli.py asserts of the single-device
    run)."""
    monkeypatch.setenv("VISFD_FUSED_EIGEN", "1")
    for k in ("VISFD_COORDINATOR", "VISFD_NUM_PROCESSES"):
        monkeypatch.delenv(k, raising=False)
    args = f"-in {phantom}/in.mrc " + CLI_CASES[case].format(d=phantom)
    out_j = phantom / f"jax_{case}.mrc"
    assert JFM.run(args.split() + ["-out", str(out_j), "-mesh", "8"]) == 0
    a = mrc.read_mrc(str(out_j)).data
    b, _ = _torch_cli(phantom, args, f"jaxcmp_{case}", mesh=True)
    ok = np.isclose(b, a, rtol=2e-4, atol=2e-5 * np.abs(a).max())
    if case == "sparse":
        assert ok.mean() >= 0.999
    else:
        assert ok.all(), f"{(~ok).sum()} voxels disagree"


def test_cli_uneven_volume_runs_unsharded(phantom, capsys):
    args = f"-in {phantom}/odd.mrc -w 1 -membrane minima 2.5 -tv 1.0"
    meshed, paths = _torch_cli(phantom, args, "odd_8", mesh=True)
    err = capsys.readouterr().err
    assert ("-mesh: volume (21, 28, 40) not divisible by the (4, 2) "
            "device grid") in err
    assert paths["tv"] == "plain"
    single, _ = _torch_cli(phantom, args, "odd_1", mesh=False)
    np.testing.assert_array_equal(meshed, single)   # the same route


@pytest.mark.parametrize("var", ["VISFD_COORDINATOR", "VISFD_NUM_PROCESSES"])
def test_cli_refuses_a_cluster(phantom, monkeypatch, var):
    monkeypatch.setenv(var, "2")
    argv = (f"-in {phantom}/in.mrc -w 1 -membrane minima 2.5 -tv 1.0 "
            f"-mesh 8").split()
    with pytest.raises(InputError, match=f"{var}.*multi-process"):
        TFM.run(argv, device="cpu", mesh_devices=["cpu"] * 8)
    # without -mesh the variable is not read
    assert TFM.run(argv[:-2], device="cpu", report=Report(None)) == 0
