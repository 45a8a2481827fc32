"""sxmc_tpu_torch.io.native (the ``.sxnt`` event store), the loaders
and the converter, against sxmc_tpu.io.

The port keeps its own copy of the C++ store and builds it into the
checkout's ``build/``; a file written by either package is read by the
other, and the same table gives the same bytes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.io import loaders, native

torch.set_num_threads(1)

FIELDS = ["energy", "radius", "mc_energy"]


def jax_native():
    """The JAX package's store.  Its library is built beside its source
    at first use, by every pytest worker that collects
    tests/test_native_io.py at once; a worker that loaded the file while
    another was still writing it keeps that failure.  By the time a test
    runs the build is complete: clear the kept failure and load again."""
    from sxmc_tpu.io import native as jn

    if not jn.available():
        jn._lib_error = None
    assert jn.available(), jn._lib_error
    return jn


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(1)
    data = np.stack([rng.normal(10, 1, 1000), rng.uniform(0, 10, 1000),
                     rng.uniform(5, 15, 1000)], axis=1).astype(np.float32)
    return data


def test_roundtrip_and_loaders(tmp_path, table):
    """write_sxnt -> EventStore (rows, fields, read_all), and the same
    through read_float_table / write_float_table (.sxnt and .sxt)."""
    path = str(tmp_path / "mc.sxnt")
    native.write_sxnt(path, table, FIELDS)
    store = native.EventStore(path)
    assert store.nrows == 1000 and store.fields == FIELDS
    assert np.array_equal(store.read_all(), table)
    store.close()
    for ext in (".sxnt", ".sxt"):
        p = str(tmp_path / ("copy" + ext))
        loaders.write_float_table(p, table, FIELDS)
        got, names = loaders.read_float_table(p)
        assert names == FIELDS and np.array_equal(got, table)


def test_files_identical_across_packages(tmp_path, table):
    """The JAX package's store and the port's write the same bytes for
    the same table, and each reads the other's file."""
    jn = jax_native()
    pj, pt = str(tmp_path / "j.sxnt"), str(tmp_path / "t.sxnt")
    jn.write_sxnt(pj, table, FIELDS)
    native.write_sxnt(pt, table, FIELDS)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(native.EventStore(pj).read_all(), table)
    assert np.array_equal(jn.EventStore(pt).read_all(), table)


def test_select_matches_jax_and_python(tmp_path, table):
    """select(): cuts lo <= x <= hi, column mapping and the DATASET tag,
    as the JAX package's store and the port's Python path give them."""
    from sxmc_tpu_torch.signal import Observable, read_dataset_to_samples

    jn = jax_native()

    path = str(tmp_path / "mc.sxnt")
    native.write_sxnt(path, table, FIELDS)
    cuts = [("radius", 0.0, 5.0), ("energy", 9.0, 11.5)]
    got = native.EventStore(path).select(["energy", "mc_energy"], cuts,
                                         dataset_tag=3.0)
    keep = ((table[:, 1] >= 0) & (table[:, 1] <= 5) & (table[:, 0] >= 9)
            & (table[:, 0] <= 11.5))
    assert got.shape == (keep.sum(), 3)
    assert np.array_equal(got[:, :2], table[keep][:, [0, 2]])
    assert (got[:, 2] == 3.0).all()
    cut_obs = [Observable(name=f, field=f, lower=lo, upper=hi)
               for f, lo, hi in cuts]
    py = read_dataset_to_samples(table, FIELDS, 3,
                                 ["energy", "mc_energy", "DATASET"], cut_obs)
    assert np.array_equal(got, py)
    assert np.array_equal(got, jn.EventStore(path).select(
        ["energy", "mc_energy"], cuts, dataset_tag=3.0))


def test_read_float_tables_checks_the_layout(tmp_path, table):
    """read_float_tables concatenates files of one layout and refuses
    another (JAX loaders.py:55-68)."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.sxnt")
    loaders.write_float_table(a, table[:400], FIELDS)
    loaders.write_float_table(b, table[400:], FIELDS)
    data, fields = loaders.read_float_tables([a, b])
    assert fields == FIELDS and np.array_equal(data, table)
    c = str(tmp_path / "c.npz")
    loaders.write_float_table(c, table, ["x", "y", "z"])
    with pytest.raises(loaders.DataError, match="Field layout mismatch"):
        loaders.read_float_tables([a, c])


def test_converter(tmp_path, table):
    """python -m sxmc_tpu_torch.io.convert a.npz b.csv out.sxnt, and its
    help and usage exits."""
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.csv")
    out = str(tmp_path / "out.sxnt")
    loaders.write_float_table(a, table[:600], FIELDS)
    loaders.write_float_table(b, table[600:], FIELDS)
    run = subprocess.run([sys.executable, "-m", "sxmc_tpu_torch.io.convert",
                          a, b, out], capture_output=True, text=True,
                         timeout=60)
    assert run.returncode == 0, run.stderr
    assert "1000 rows" in run.stdout
    got, fields = loaders.read_float_table(out)
    assert fields == FIELDS
    np.testing.assert_allclose(got, table, rtol=1e-6)  # the csv's digits
    assert np.array_equal(got[:600], table[:600])
    from sxmc_tpu_torch.io import convert

    assert convert.main(["--help"]) == 0 and convert.main(["x"]) == 2


def test_signal_from_sxnt_equals_npz(tmp_path):
    """A config's .sxnt signal (native cuts, mapping and tag) holds the
    samples and n_mc of the same table as .npz, in both packages."""
    import importlib

    from test_torch_pdf import make_stack_inputs

    jax_native()  # the JAX package reads .sxnt natively when it loads

    rng = np.random.default_rng(4)
    fields = ["energy", "true", "radius"]
    t = np.stack([rng.normal(10, 1.5, 800), rng.normal(10, 1.5, 800),
                  rng.uniform(0, 10, 800)], axis=1).astype(np.float32)
    loaders.write_float_table(str(tmp_path / "s.npz"), t, fields)
    loaders.write_float_table(str(tmp_path / "s.sxnt"), t, fields)
    samples = {}
    for pkg in ("sxmc_tpu_torch", "sxmc_tpu"):
        sig = importlib.import_module(pkg + ".signal")
        srcs, _, systs, obs = make_stack_inputs(pkg, n_mc=10)
        cut = sig.Observable(name="radius", field="radius", lower=0.0,
                             upper=6.0)
        got = [sig.Signal.from_file(
            "a", "a", str(tmp_path / ("s" + ext)), 0, srcs[0], -0.5,
            ["energy", "true", "DATASET"], obs, [cut], systs[:1])
            for ext in (".npz", ".sxnt")]
        assert got[0].n_mc == got[1].n_mc == 800
        assert got[0].nexpected == got[1].nexpected == 400.0
        assert np.array_equal(got[0].histogram.samples_host,
                              got[1].histogram.samples_host)
        samples[pkg] = got[1].histogram.samples_host
    assert np.array_equal(samples["sxmc_tpu_torch"], samples["sxmc_tpu"])


def test_library_builds_into_build_dir():
    """The library lives under the checkout's build/, never beside the
    source in sxmc_tpu_torch/."""
    assert native.available()
    lib = native.library_path()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        native.__file__)))
    assert lib.exists() and "build" in lib.parts
    assert not str(lib).startswith(root)
    src_dir = os.path.dirname(os.path.abspath(native.__file__))
    assert sorted(os.listdir(src_dir)) in (
        ["__init__.py", "evstore.cpp"],
        ["__init__.py", "__pycache__", "evstore.cpp"])
