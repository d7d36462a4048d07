"""Scientific I/O conveniences: the port of ``tqdne_tpu/utils/io.py``.

The reference's data-access helpers (its ``experiments/utils.py``):
``load_mat`` (``MatFileHandler``, a recursive MATLAB-struct-to-dict reader)
and ``SeismicParameters`` (dot access over the datasets of an HDF5 file).
``h5py`` is imported where a file is opened.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_mat(path: str | Path) -> dict:
    """Read a MATLAB .mat file into nested plain dicts and arrays (v7 through
    scipy, v7.3 through h5py)."""
    path = Path(path)
    try:
        from scipy.io import loadmat

        raw = loadmat(str(path), squeeze_me=True, struct_as_record=False)
    except NotImplementedError:  # v7.3 = HDF5
        import h5py

        with h5py.File(path, "r") as f:
            return {k: _h5_to_dict(f[k]) for k in f.keys()}

    def convert(obj):
        if hasattr(obj, "_fieldnames"):  # mat_struct
            return {name: convert(getattr(obj, name)) for name in obj._fieldnames}
        if isinstance(obj, np.ndarray) and obj.dtype == object:
            return [convert(o) for o in obj.ravel()]
        return obj

    return {k: convert(v) for k, v in raw.items() if not k.startswith("__")}


def _h5_to_dict(node):
    import h5py

    if isinstance(node, h5py.Dataset):
        return node[()]
    return {k: _h5_to_dict(node[k]) for k in node.keys()}


class SeismicParameters:
    """Dot-access reader over an HDF5 dataset file:
    ``p = SeismicParameters("preprocessed_waveforms.h5"); p.magnitude``.

    Datasets load on first attribute access and are cached; arrays up to
    64 MiB come back as numpy, larger ones (``waveforms``) stay h5py datasets
    until sliced.
    """

    _EAGER_LIMIT = 64 * 1024 * 1024  # bytes

    def __init__(self, file_path: str | Path):
        import h5py

        self._file = h5py.File(file_path, "r", locking=False)
        self._cache: dict = {}

    def keys(self):
        return list(self._file.keys())

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._cache:
            return self._cache[name]
        name_in_file = name
        if name not in self._file:
            # the reference stores "vs30s" in generated files and "vs30" in
            # preprocessed ones; either spelling reads either
            alt = name.rstrip("s") if name.endswith("s") else name + "s"
            if alt not in self._file:
                raise AttributeError(f"{name} not in {list(self._file.keys())}")
            name_in_file = alt
        ds = self._file[name_in_file]
        value = ds[()] if ds.size * ds.dtype.itemsize <= self._EAGER_LIMIT else ds
        self._cache[name] = value
        return value

    def get_data_info(self) -> dict:
        return {k: (self._file[k].shape, str(self._file[k].dtype)) for k in self._file}

    def close(self):
        self._file.close()

    def __repr__(self):
        return f"SeismicParameters({self.get_data_info()})"
