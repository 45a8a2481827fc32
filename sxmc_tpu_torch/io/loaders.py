"""Data ingestion: MC ntuples as flat float matrices.

Copied from ``sxmc_tpu/io/loaders.py``: ``read_float_table`` returns
``(data, fields)`` where ``data`` is a row-major float32 matrix and
``fields`` the column names (reference: src/io/ttree_io.{h,cpp}).

Supported formats (by extension): ``.npz``, ``.npy``, ``.csv``,
``.h5``/``.hdf5`` (h5py, imported only when such a file is used),
``.sxnt``/``.sxt`` (the native event store, ``io.native``: built with
g++ at first use) and ``.root`` (uproot, optional).  Several files may
be concatenated (:func:`read_float_tables`); like the reference
(ttree_io.cpp:80-86), all of them must have the same field layout.
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np


class DataError(RuntimeError):
    pass


def read_float_table(filename: str) -> Tuple[np.ndarray, List[str]]:
    """Read one file into a (n, nfields) float32 matrix + field names."""
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".npz":
        return _read_npz(filename)
    if ext == ".npy":
        return _read_npy(filename)
    if ext == ".csv":
        return _read_csv(filename)
    if ext in (".h5", ".hdf5"):
        return _read_hdf5(filename)
    if ext in (".sxnt", ".sxt"):
        return _read_sxnt(filename)
    if ext == ".root":
        return _read_root(filename)
    raise DataError(f"Unsupported data format: {filename}")


def read_float_tables(filenames: Sequence[str]
                      ) -> Tuple[np.ndarray, List[str]]:
    """Read and concatenate several files (ttree_io.cpp:124-126)."""
    datas = []
    fields: List[str] = []
    for fn in filenames:
        d, f = read_float_table(fn)
        if fields and f != fields:
            raise DataError(
                f"Field layout mismatch in {fn}: {f} != {fields}")
        fields = f
        datas.append(d)
    return np.concatenate(datas, axis=0), fields


def write_float_table(filename: str, data: np.ndarray,
                      fields: Sequence[str]) -> None:
    """Write a float table in any supported format (for outputs/tests)."""
    data = np.asarray(data, np.float32)
    ext = os.path.splitext(filename)[1].lower()
    if ext == ".npz":
        np.savez(filename, data=data, fields=np.asarray(list(fields)))
    elif ext == ".csv":
        np.savetxt(filename, data, delimiter=",",
                   header=",".join(fields), comments="")
    elif ext in (".h5", ".hdf5"):
        import h5py

        with h5py.File(filename, "w") as f:
            ds = f.create_dataset("data", data=data)
            ds.attrs["fields"] = list(fields)
    elif ext in (".sxnt", ".sxt"):
        from sxmc_tpu_torch.io import native

        native.write_sxnt(filename, data, fields)
    elif ext == ".root":
        _write_root(filename, data, fields)
    else:
        raise DataError(f"Unsupported output format: {filename}")


def _as_float_matrix(cols: List[np.ndarray], names: List[str]):
    data = np.stack([np.asarray(c, np.float32) for c in cols], axis=1)
    return data, names


def _read_npz(filename: str):
    with np.load(filename, allow_pickle=False) as f:
        keys = list(f.keys())
        if "data" in keys:
            data = np.asarray(f["data"], np.float32)
            if "fields" in keys:
                fields = [str(s) for s in f["fields"]]
            else:
                fields = [f"f{i}" for i in range(data.shape[1])]
            return data, fields
        cols = [f[k] for k in keys]
        return _as_float_matrix(cols, keys)


def _read_npy(filename: str):
    arr = np.load(filename, allow_pickle=False)
    if arr.dtype.names:
        names = list(arr.dtype.names)
        return _as_float_matrix([arr[n] for n in names], names)
    arr = np.atleast_2d(np.asarray(arr, np.float32))
    return arr, [f"f{i}" for i in range(arr.shape[1])]


def _read_csv(filename: str):
    with open(filename) as f:
        header = f.readline().strip()
    fields = [s.strip() for s in header.split(",")]
    data = np.loadtxt(filename, delimiter=",", skiprows=1, dtype=np.float32,
                      ndmin=2)
    return data, fields


def _read_hdf5(filename: str):
    import h5py

    with h5py.File(filename, "r") as f:
        if "data" in f:
            ds = f["data"]
            data = np.asarray(ds, np.float32)
            fields = [str(s) for s in ds.attrs.get(
                "fields", [f"f{i}" for i in range(data.shape[1])])]
            return data, fields
        names = sorted(f.keys())
        return _as_float_matrix([np.asarray(f[n]) for n in names], names)


def _read_sxnt(filename: str):
    from sxmc_tpu_torch.io import native

    store = native.EventStore(filename)
    try:
        return store.read_all(), list(store.fields)
    finally:
        store.close()


def _write_root(filename: str, data: np.ndarray,
                fields: Sequence[str]) -> None:
    try:
        import uproot  # type: ignore
    except ImportError as e:
        raise DataError(
            "Writing .root files requires uproot, which is not "
            "installed. Use .hdf5/.npz output instead.") from e

    with uproot.recreate(filename) as f:
        f["ls"] = {name: np.ascontiguousarray(data[:, i], np.float32)
                   for i, name in enumerate(fields)}


def _read_root(filename: str):
    try:
        import uproot  # type: ignore
    except ImportError as e:
        raise DataError(
            "Reading .root files requires uproot, which is not installed. "
            "Convert the ntuple to .npz/.hdf5/.csv instead.") from e

    with uproot.open(filename) as f:
        tree = None
        for key in f.keys():
            obj = f[key]
            if hasattr(obj, "arrays"):
                tree = obj
                break
        if tree is None:
            raise DataError(f"No TTree found in {filename}")
        arrays = tree.arrays(library="np")
        names = []
        cols = []
        for name, col in arrays.items():
            if col.dtype.kind in "fiub" and col.ndim == 1:
                names.append(str(name))
                cols.append(col)
        return _as_float_matrix(cols, names)
