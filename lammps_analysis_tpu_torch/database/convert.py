"""Carry a JAX-package trajectory store (HDF5) across to the port's npy store.

The JAX package keeps an experiment's trajectory in
``<experiment>/database.h5``; the port keeps it in ``<experiment>/database/``
(see ``trajectory_store.py``). The sqlite results DB has the same schema in
both packages, so converting the trajectory store is all it takes for a port
``Project`` to open a JAX project. ``h5py`` is imported only here, inside the
function: the port's main path never needs it.
"""

from __future__ import annotations

import pathlib
from typing import Union

from .trajectory_store import TrajectoryStore, join_path

#: frames copied per slab (bounds host memory for large stores)
_SLAB_BYTES = 2**28


def store_from_hdf5(
    h5_path: Union[str, pathlib.Path], store_dir: Union[str, pathlib.Path]
) -> TrajectoryStore:
    """Copy every dataset and append cursor of ``h5_path`` into ``store_dir``.

    Datasets keep their shape and dtype; each cursor is the HDF5 dataset's
    ``starting_index`` attribute.
    """
    import h5py

    store = TrajectoryStore(store_dir)
    with h5py.File(h5_path, "r") as db:
        for species in db:
            for prop, ds in db[species].items():
                n_configs, n_particles, n_dims = ds.shape
                store.ensure_dataset(
                    species, prop, n_configs, n_particles, n_dims, dtype=ds.dtype
                )
                path = join_path(species, prop)
                out = store._open_for_write(path)
                step = max(_SLAB_BYTES // max(ds.dtype.itemsize * n_particles * n_dims, 1), 1)
                for start in range(0, n_configs, step):
                    out[start : start + step] = ds[start : start + step]
                out.flush()
                del out
                store.set_cursor(path, int(ds.attrs["starting_index"]))
    return store
