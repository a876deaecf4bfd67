"""Optional packages, imported where they are used.

h5py and zarr are imported only on the branches that read or write their
formats, so the rest of the port runs on a machine without them; a missing
one raises ImportError naming what needed it.
"""

import importlib

_H5_HINT = "npy shards (make_synthetic_dataset --format bin) and .npy invariants need no h5py"


def import_optional(module, what, hint=_H5_HINT):
    """The module, or ImportError naming `what` needed it and `hint`."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs {module}, which is not installed; {hint}") from e
