"""Per-stage result cache (a copy of ``stereo_reconstruction_cv_tpu/pipeline/cache.py``).

A stage persists its arrays as one compressed .npz named by the stage and a
hash of its inputs' key (file fingerprints or content hashes, and every
parameter that changes the output), so a later run restarts from it. The
key hashing, the file layout and the default root are the reference's.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

import numpy as np


class StageCache:
    """Stage results under `root`: load(stage, key) -> dict of arrays or None,
    save(stage, key, arrays) -> the file's path."""

    def __init__(self, root: str = ".stereo_tpu_cache"):
        self.root = root

    def _path(self, stage: str, key: Dict[str, Any]) -> str:
        blob = json.dumps(key, sort_keys=True, default=str).encode()
        h = hashlib.sha1(blob).hexdigest()[:16]
        return os.path.join(self.root, f"{stage}-{h}.npz")

    def load(self, stage: str, key: Dict[str, Any]):
        p = self._path(stage, key)
        if not os.path.exists(p):
            return None
        with np.load(p, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save(self, stage: str, key: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> str:
        os.makedirs(self.root, exist_ok=True)
        p = self._path(stage, key)
        np.savez_compressed(p, **{k: np.asarray(v) for k, v in arrays.items()})
        return p


def file_fingerprint(path: str) -> Dict[str, Any]:
    """A file's absolute path, size and whole-second mtime."""
    st = os.stat(path)
    return {"path": os.path.abspath(path), "size": st.st_size, "mtime": int(st.st_mtime)}
