"""Logical table schemas and key design.

The port's own copy of the JAX package's ``store/schema.py``: the same
tables, keys and column types, so a store either package writes reads
the same in the other.

Mirrors the reference's Cassandra schema (resources/schema.cql) and table
modules:

- chip    (cx, cy) -> dates[]                 (schema.cql:30-34, ccdc/chip.py)
- pixel   (cx, cy, px, py) -> mask[]          (schema.cql:48-54, ccdc/pixel.py)
- segment (cx, cy, px, py, sday, eday) -> 33 model columns + rfrawp
                                              (schema.cql:103-142, ccdc/segment.py)
- tile    (tx, ty, name) -> model, updated    (schema.cql:13-19, ccdc/tile.py)

Column types: INTEGER/REAL/TEXT scalars; JSON for irregular values (ISO
date lists); and packed-array types for the hot egress columns — BITS
(uint8, the per-pixel processing mask), F64S (float64 vectors: model
coefficients, rfrawp), I32S (int32 rasters: product cells).  Packed
columns are raw little-endian bytes in sqlite/cassandra (the egress path
is host-bound: JSON-encoding a 10k-pixel chip's masks alone costs
seconds per chip) and plain lists in parquet/memory; every backend's
read() returns plain lists either way.
"""

from __future__ import annotations

import numpy as np

from firebird_tpu_torch.ccd.format import BAND_PREFIX

# numpy dtypes of the packed-array column types (little-endian on the wire)
PACKED_DTYPES = {"BITS": np.uint8, "F64S": "<f8", "I32S": "<i4"}

_SEG_BANDS: list[tuple[str, str]] = []
for _p in BAND_PREFIX:
    _SEG_BANDS += [(f"{_p}mag", "REAL"), (f"{_p}rmse", "REAL"),
                   (f"{_p}coef", "F64S"), (f"{_p}int", "REAL")]

TABLES: dict[str, dict] = {
    "chip": {
        "columns": [("cx", "INTEGER"), ("cy", "INTEGER"), ("dates", "JSON")],
        "key": ("cx", "cy"),
    },
    "pixel": {
        "columns": [("cx", "INTEGER"), ("cy", "INTEGER"), ("px", "INTEGER"),
                    ("py", "INTEGER"), ("mask", "BITS")],
        "key": ("cx", "cy", "px", "py"),
    },
    "segment": {
        "columns": ([("cx", "INTEGER"), ("cy", "INTEGER"), ("px", "INTEGER"),
                     ("py", "INTEGER"), ("sday", "TEXT"), ("eday", "TEXT"),
                     ("bday", "TEXT"), ("chprob", "REAL"),
                     ("curqa", "INTEGER")]
                    + _SEG_BANDS + [("rfrawp", "F64S")]),
        "key": ("cx", "cy", "px", "py", "sday", "eday"),
    },
    "tile": {
        "columns": [("tx", "INTEGER"), ("ty", "INTEGER"), ("name", "TEXT"),
                    ("model", "TEXT"), ("updated", "TEXT")],
        "key": ("tx", "ty", "name"),
    },
    # Derived product rasters (the reference 0.5 `ccdc-save` capability,
    # docs/faq.rst:38-109; dropped by 1.0 — completed here, SURVEY.md §2.5).
    # One row per (product, date, chip): row-major [100x100] cell values.
    "product": {
        "columns": [("name", "TEXT"), ("date", "TEXT"), ("cx", "INTEGER"),
                    ("cy", "INTEGER"), ("cells", "I32S")],
        "key": ("name", "date", "cx", "cy"),
    },
}


def primary_key(table: str) -> tuple[str, ...]:
    return TABLES[table]["key"]


def columns(table: str) -> list[str]:
    return [c for c, _ in TABLES[table]["columns"]]
