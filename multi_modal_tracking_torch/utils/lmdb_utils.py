"""LMDB-backed dataset IO (the port's own copy of the JAX package's
`utils/lmdb_utils.py`; JPEG records decode through the port's decoder).

Parity target: lib/utils/lmdb_utils.py (:11-47) — per-path lmdb handle cache
and jpg/str/json record decoding used by the *_lmdb dataset twins
(lib/train/dataset/*_lmdb.py). The `lmdb` package is optional in this
environment; every entry raises a clear ImportError when it is missing, and
the dataset registry only constructs LMDB variants on demand.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

_env_cache: Dict[str, object] = {}


def _lmdb():
    try:
        import lmdb
        return lmdb
    except ImportError as e:
        raise ImportError(
            "LMDB dataset support requires the 'lmdb' package "
            "(pip install lmdb); falling back to the filesystem adapters "
            "in train/data/datasets is equivalent.") from e


def get_env(db_path: str):
    """Cached read-only environment handle (lmdb_utils.py:11-20)."""
    if db_path not in _env_cache:
        _env_cache[db_path] = _lmdb().open(
            db_path, readonly=True, lock=False, readahead=False, meminit=False)
    return _env_cache[db_path]


def decode_img(db_path: str, key: str) -> np.ndarray:
    """jpeg bytes at key -> RGB uint8 array (lmdb_utils.py decode_img)."""
    from multi_modal_tracking_torch import native
    env = get_env(db_path)
    with env.begin(write=False) as txn:
        buf = txn.get(key.encode())
    if buf is None:
        raise KeyError(f"{key} not in {db_path}")
    return native.imdecode(bytes(buf), f"{db_path} key {key!r}")


def decode_str(db_path: str, key: str) -> Optional[str]:
    env = get_env(db_path)
    with env.begin(write=False) as txn:
        buf = txn.get(key.encode())
    return buf.decode() if buf is not None else None


def decode_json(db_path: str, key: str):
    s = decode_str(db_path, key)
    return json.loads(s) if s is not None else None
