"""The trained model as the tile table stores it, read without the forest.

A tile's model is one JSON document in the tile table's ``model`` column
(the JAX package's format, :data:`FORMAT`: each array base64 with its
dtype and shape).  The serving layer needs only its class order (the
``cover`` product maps a segment's vote argmax through it), and a serve
replica runs on the host: this module reads that order with numpy alone,
so a cold ``cover`` miss never loads torch or the detector.
:mod:`~firebird_tpu_torch.rf.forest` decodes the whole model with the same
helpers, and :mod:`~firebird_tpu_torch.rf.pipeline` re-exports
:data:`MODEL_NAME` and :func:`read_model`.
"""

from __future__ import annotations

import base64
import json

import numpy as np

MODEL_NAME = "random-forest"
# The tile table's model format, shared with the JAX package: a model
# stored by either package loads in the other.
FORMAT = "firebird_tpu.rf.v1"


def decode_array(e: dict) -> np.ndarray:
    """One array of a stored model document."""
    a = np.frombuffer(base64.b64decode(e["data"]), dtype=e["dtype"])
    return a.reshape(e["shape"]).copy()


def parse(text: str) -> dict:
    """A stored model document, its format checked."""
    d = json.loads(text)
    if d.get("format") != FORMAT:
        raise ValueError(f"unknown model format: {d.get('format')!r}")
    return d


def read_model(store, tx: int, ty: int,
               name: str = MODEL_NAME) -> str | None:
    """The stored model document of tile (tx, ty), or None."""
    rows = store.read("tile", where={"tx": int(tx), "ty": int(ty),
                                     "name": name})
    return rows["model"][0] if rows["model"] else None


def model_classes(store, tx: int, ty: int,
                  name: str = MODEL_NAME) -> np.ndarray | None:
    """The stored model's class order (``RandomForest.classes``: the
    original label values, frequency-ordered), or None when tile (tx, ty)
    has no model."""
    text = read_model(store, tx, ty, name)
    return None if text is None else decode_array(parse(text)["classes"])
