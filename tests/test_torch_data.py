"""The port's data layer (``poseidon_tpu_torch.data``) against the JAX
package's (``poseidon_tpu.data``), on the synthetic HDF5 files of
``tests/test_data.py`` (its ``data_dir`` fixture, imported, plus links under
the names of the datasets that share a schema): every dataset of
``get_dataset`` and its ``.tracer``, ``.time`` and ``.out`` variants gives
the same samples, exactly (numpy, ``array_equal``), and the same split and
channel metadata; the loader gives the same batches, in the same order,
with the same padding, host slices and ``start_batch``; and a file stored as
a directory of ``.npy`` arrays reads as its HDF5 twin."""

import os

import h5py
import numpy as np
import pytest

from poseidon_tpu.data import native as jnative
from poseidon_tpu.data import registry as jregistry
from poseidon_tpu.data import time_sampling as jts
from poseidon_tpu.data.loader import DataLoader as JDataLoader

from poseidon_tpu_torch.data import base as pbase
from poseidon_tpu_torch.data import native as pnative
from poseidon_tpu_torch.data import registry as pregistry
from poseidon_tpu_torch.data import time_sampling as pts
from poseidon_tpu_torch.data.loader import DataLoader as PDataLoader

from test_data import data_dir, shrink_splits  # noqa: F401  (fixtures)

# Files that share another's schema: a link to it under the name the
# dataset opens.
ALIASES = {"NS-BB.nc": "NS-PwC.nc", "NS-Gauss.nc": "NS-PwC.nc", "NS-SL.nc": "NS-PwC.nc",
           "NS-SVS.nc": "NS-PwC.nc", "NS-Sines.nc": "NS-PwC.nc", "CE-Gauss.nc": "CE-RP.nc",
           "CE-KH.nc": "CE-RP.nc", "CE-CRP.nc": "CE-RP.nc", "CE-RPUI.nc": "CE-RP.nc",
           "Wave-Gauss.nc": "Wave-Layer.nc"}

NAMES = [
    "fluids.incompressible.BrownianBridge", "fluids.incompressible.Gaussians",
    "fluids.incompressible.ShearLayer", "fluids.incompressible.Sines",
    "fluids.incompressible.PiecewiseConstants", "fluids.incompressible.PiecewiseConstants.tracer",
    "fluids.incompressible.VortexSheet", "fluids.incompressible.forcing.KolmogorovFlow",
    "fluids.compressible.Riemann", "fluids.compressible.RiemannCurved",
    "fluids.compressible.RiemannKelvinHelmholtz", "fluids.compressible.KelvinHelmholtz",
    "fluids.compressible.Gaussians", "fluids.compressible.RichtmyerMeshkov",
    "fluids.compressible.RichtmyerMeshkov.tracer", "fluids.compressible.gravity.RayleighTaylor",
    "fluids.compressible.gravity.RayleighTaylor.tracer", "fluids.compressible.steady.Airfoil",
    "fluids.compressible.steady.Airfoil.time", "elliptic.poisson.Gaussians",
    "elliptic.poisson.Gaussians.time", "elliptic.Helmholtz", "elliptic.Helmholtz.time",
    "wave.Layer", "wave.Gaussians", "reaction_diffusion.AllenCahn",
    "fluids.incompressible.Sines.out", "fluids.compressible.Riemann.out",
    "fluids.compressible.gravity.RayleighTaylor.out", "wave.Layer.out",
    "reaction_diffusion.AllenCahn.out"]


@pytest.fixture(scope="module")
def all_data(data_dir):  # noqa: F811
    for name, target in ALIASES.items():
        path = os.path.join(data_dir, name)
        if not os.path.exists(path):
            os.symlink(os.path.join(data_dir, target), path)
    path = os.path.join(data_dir, "CE-RM.nc")  # solution (N, T, 5, H, W)
    if not os.path.exists(path):
        with h5py.File(path, "w") as f:
            f["solution"] = h5py.ExternalLink(os.path.join(data_dir, "CE-RP.nc"), "/data")
    return data_dir


@pytest.fixture(autouse=True)
def shrink_port_splits(monkeypatch):
    """The port's split constants shrunk as ``shrink_splits`` shrinks the
    JAX package's, to fit the 8-trajectory files."""
    for cls in (pbase.BaseDataset, pbase.BaseTimeDataset):
        orig = cls.post_init

        def post_init(self, _orig=orig):
            self.N_max, self.N_val, self.N_test = 8, 2, 2
            _orig(self)

        monkeypatch.setattr(cls, "post_init", post_init)


def _same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


def _same_meta(ours, theirs):
    assert len(ours) == len(theirs)
    for attr in ("input_dim", "output_dim", "channel_slice_list",
                 "printable_channel_description", "resolution"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("name", NAMES)
def test_dataset_matches_jax(name, all_data):
    kw = dict(which="train", num_trajectories=2, data_path=all_data)
    ours, theirs = pregistry.get_dataset(name, **kw), jregistry.get_dataset(name, **kw)
    _same_meta(ours, theirs)
    for i in sorted({0, len(ours) // 2, len(ours) - 1}):
        _same_sample(ours[i], theirs[i])


@pytest.mark.parametrize("which", ["val", "test"])
def test_splits_match_jax(which, all_data):
    kw = dict(which=which, num_trajectories=2, data_path=all_data)
    for name in ("fluids.compressible.Gaussians", "elliptic.poisson.Gaussians"):
        ours, theirs = pregistry.get_dataset(name, **kw), jregistry.get_dataset(name, **kw)
        _same_meta(ours, theirs)
        _same_sample(ours[len(ours) - 1], theirs[len(theirs) - 1])


def test_dataset_options_and_mixture_match_jax(all_data):
    kw = dict(which="train", num_trajectories=2, data_path=all_data)
    for name, extra in (("fluids.incompressible.PiecewiseConstants", {"just_velocities": True}),
                        ("fluids.incompressible.PiecewiseConstants", {"resolution": 64}),
                        ("reaction_diffusion.AllenCahn", {"fix_input_to_time_step": 0}),
                        ("wave.Layer", {"allowed_time_transitions": [1, 2]})):
        ours = pregistry.get_dataset(name, **kw, **extra)
        theirs = jregistry.get_dataset(name, **kw, **extra)
        _same_meta(ours, theirs)
        _same_sample(ours[len(ours) - 1], theirs[len(theirs) - 1])
    mix = ["fluids.compressible.Riemann", "fluids.compressible.Gaussians"]
    ours, theirs = pregistry.get_dataset(mix, **kw), jregistry.get_dataset(mix, **kw)
    _same_meta(ours, theirs)
    for i in (0, len(ours) - 1):
        _same_sample(ours[i], theirs[i])
    with pytest.raises(ValueError, match="Unknown dataset"):
        pregistry.get_dataset("fluids.incompressible.Nope", **kw)


@pytest.mark.parametrize("name,file,keys", [
    ("fluids.compressible.Gaussians", "CE-Gauss.nc", ("data",)),
    ("elliptic.poisson.Gaussians", "Poisson-Gauss.nc", ("source", "solution")),
    ("wave.Layer", "Wave-Layer.nc", ("solution", "c"))])
def test_npy_directory_reads_as_hdf5(name, file, keys, all_data, tmp_path):
    """A file as a directory of ``<key>.npy`` arrays (``open_data_file``'s
    format for machines without h5py) gives the HDF5 file's samples."""
    os.makedirs(tmp_path / file)
    with h5py.File(os.path.join(all_data, file), "r") as f:
        for k in keys:
            np.save(tmp_path / file / f"{k}.npy", f[k][()])
    kw = dict(which="train", num_trajectories=2)
    ours = pregistry.get_dataset(name, data_path=str(tmp_path), **kw)
    theirs = jregistry.get_dataset(name, data_path=all_data, **kw)
    _same_meta(ours, theirs)
    for i in (0, len(ours) - 1):
        _same_sample(ours[i], theirs[i])


def test_time_sampling_and_hdf5_default_match_jax():
    for steps, size, allowed in ((7, 2, None), (10, 1, [1, 3]), (4, 3, None)):
        assert pts.build_time_indices(steps, size, allowed) == \
            jts.build_time_indices(steps, size, allowed)
    for args in ((5, 120, 120, 240), (-1, 1000, 120, 240)):
        assert pts.resolve_num_trajectories(*args) == jts.resolve_num_trajectories(*args)
    assert os.environ.get("HDF5_USE_FILE_LOCKING") == "FALSE"


class _Ids:
    """Sample i holds i, as an image and a scalar time."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"pixel_values": np.full((2, 4, 4), i, np.float32),
                "labels": np.full((1, 4, 4), -i, np.float32), "time": np.float32(i / 10)}


def _batches(loader, epoch=0, start_batch=0):
    return list(loader.epoch(epoch, start_batch=start_batch))


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=3, drop_last=True),
                                dict(shuffle=False, drop_last=False),
                                dict(shuffle=True, seed=1, drop_last=False, num_hosts=2,
                                     host_id=1)], ids=["train", "eval_padded", "two_hosts"])
def test_loader_matches_jax(kw):
    ds = _Ids(21)
    ours, theirs = PDataLoader(ds, 4, num_workers=2, **kw), JDataLoader(ds, 4, num_workers=2, **kw)
    assert len(ours) == len(theirs)
    for epoch in (0, 1):
        a, b = _batches(ours, epoch), _batches(theirs, epoch)
        assert len(a) == len(b) == len(ours)
        for x, y in zip(a, b):
            _same_sample(x, y)
    # start_batch skips the first batches and yields the same rest.
    for x, y in zip(_batches(ours, 1, start_batch=2), _batches(theirs, 1)[2:]):
        _same_sample(x, y)
    if not kw["drop_last"]:
        last = _batches(ours)[-1]
        assert int(last["_valid_global"]) == 21 - 4 * (len(ours) - 1)


def test_loader_on_hdf5_matches_jax(all_data):
    kw = dict(which="train", num_trajectories=2, data_path=all_data)
    name = "fluids.compressible.Gaussians"
    ours = PDataLoader(pregistry.get_dataset(name, **kw), 8, seed=5, num_workers=2)
    theirs = JDataLoader(jregistry.get_dataset(name, **kw), 8, seed=5, num_workers=2)
    for x, y in zip(_batches(ours, 1), _batches(theirs, 1)):
        _same_sample(x, y)


def test_native_collate_matches_jax():
    arrays = [np.random.default_rng(i).normal(size=(3, 5, 5)).astype(np.float32)
              for i in range(6)]
    assert pnative.available() == jnative.available()
    np.testing.assert_array_equal(pnative.collate_stack(arrays), jnative.collate_stack(arrays))
