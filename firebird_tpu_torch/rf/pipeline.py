"""Classification orchestration: train on the 3x3 neighborhood, classify
the tile, persist predictions and the model.

The port's own copy of the JAX package's ``rf/pipeline.py``, which
replaces ccdc/core.py:156-251 including the predict/persist path the
reference left commented out (core.py:190-240) and the empty model
read/write stubs (ccdc/randomforest.py:17-22):

- training mirrors randomforest.train (randomforest.py:42-87): aux rows
  with trends[0] not in (0, 9), segments from the store windowed
  'sday >= msday AND eday <= meday', features joined per pixel;
- classification scores every real segment of the tile, joins rfrawp back
  into the segment rows by full key (ccdc/segment.py:103-116), and
  upserts them;
- the trained model is serialized into the tile table
  (tx, ty, name) -> model, updated (ccdc/tile.py:28-43), in the JAX
  package's format, so either package loads the other's model.

The forest trains and predicts on ``device`` (default CUDA; without a
card the calls raise unless "cpu" is asked).  Segments are read from the
store, so change detection must have run for the same keyspace first.
Each stage's seconds land in the metrics registry
(:func:`classification_stage_seconds`).
"""

from __future__ import annotations

import datetime

import numpy as np

from firebird_tpu_torch import grid
from firebird_tpu_torch.ccd.kernel import resolve_device
from firebird_tpu_torch.obs import Counters, logger
from firebird_tpu_torch.obs import metrics as obs_metrics
from firebird_tpu_torch.rf import features, forest
from firebird_tpu_torch.store import AsyncWriter
from firebird_tpu_torch.utils.fn import take

MODEL_NAME = "random-forest"

# The stages of a classification run and their histograms: store read,
# feature assembly, binning, the bootstrap draw and the tree growth (spans
# on the card's timeline on CUDA), the model save, inference (host wall,
# and its span on the card) and the writer's store writes.
STAGES = dict(store_read="rf_store_read_seconds",
              assemble="rf_assemble_seconds", bin="rf_bin_seconds",
              draw="rf_draw_seconds", grow="rf_grow_seconds",
              train="rf_train_seconds", model_save="rf_model_save_seconds",
              predict="rf_predict_seconds",
              predict_device="rf_predict_device_seconds",
              write="store_write_seconds")


def classification_stage_seconds() -> dict:
    """The current registry's seconds of each stage in :data:`STAGES`,
    each the sum over its calls."""
    snap = obs_metrics.get_registry().snapshot()["histograms"]
    return {k: snap.get(v, {}).get("sum", 0.0) for k, v in STAGES.items()}


def _observe(name: str, tm) -> None:
    obs_metrics.histogram(STAGES[name]).observe(tm.elapsed)


def _chip_segments(store, cx: int, cy: int) -> dict | None:
    with obs_metrics.timer() as tm:
        seg = store.read("segment", where={"cx": int(cx), "cy": int(cy)})
    _observe("store_read", tm)
    return seg if seg["sday"] else None


def _assemble(seg, aux, cx, cy, row_mask):
    with obs_metrics.timer() as tm:
        out = features.assemble(seg, aux, cx, cy, row_mask=row_mask)
    _observe("assemble", tm)
    return out


def training_data(cids, *, msday: int, meday: int, acquired: str,
                  aux_source, store, log=None):
    """Assemble (X [N, 33], y [N]) over a set of chip ids
    (ref randomforest.train, ccdc/randomforest.py:42-87)."""
    xs, ys = [], []
    # Distinct detected chips ∩ requested chips (ccdc/randomforest.py:67's
    # select(cx,cy).distinct()): skips the store scan for undetected chips.
    have = store.chip_ids("segment")
    for cx, cy in cids:
        if (int(cx), int(cy)) not in have:
            continue
        seg = _chip_segments(store, cx, cy)
        if seg is None:
            continue
        try:
            aux = aux_source.aux(cx, cy, acquired)
        except LookupError:
            continue
        mask = (features.real_rows(seg)
                & features.segment_window(seg, msday, meday))
        if not mask.any():
            continue
        X, meta = _assemble(seg, aux, cx, cy, mask)
        label = np.asarray(meta["label"])
        keep = ~np.isin(label, features.TRENDS_EXCLUDE)   # randomforest.py:63
        keep &= np.isfinite(X).all(axis=1)
        if keep.any():
            xs.append(X[keep])
            ys.append(label[keep])
    if not xs:
        return None, None
    X = np.concatenate(xs)
    y = np.concatenate(ys)
    if log:
        log.debug("feature row count:%d  feature columns:%d",
                  X.shape[0], X.shape[1])
    return X, y


def train_tile(x, y, *, msday: int, meday: int, acquired: str, aux_source,
               store, number: int | None = None, log=None, device=None,
               counters: Counters | None = None,
               **train_kw) -> forest.RandomForest | None:
    """Train on the 3x3 tile neighborhood around (x, y) on ``device``; None
    when no features exist (ref core.training, core.py:127-153).
    ``counters``, when given, counts the training rows."""
    dev = resolve_device(device)
    log = log or logger("random-forest-training")
    cids = grid.training(x, y)
    if number is not None:
        cids = list(take(number, cids))
    X, yv = training_data(cids, msday=msday, meday=meday, acquired=acquired,
                          aux_source=aux_source, store=store, log=log)
    if X is None:
        log.info("No features found to train model")   # randomforest.py:76
        return None
    log.info("training random forest on %d rows on %s", X.shape[0], dev)
    if counters is not None:
        counters.add("training_rows", X.shape[0])
    with obs_metrics.timer() as tm:
        model = forest.train(X, yv, device=dev, **train_kw)
    _observe("train", tm)
    return model


def save_model(store, tx: int, ty: int, model: forest.RandomForest,
               name: str = MODEL_NAME) -> None:
    """Persist a model into the tile table (ccdc/tile.py:28-43)."""
    with obs_metrics.timer() as tm:
        store.write("tile", {
            "tx": [int(tx)], "ty": [int(ty)], "name": [name],
            "model": [model.dumps()],
            "updated": [datetime.datetime.now(
                datetime.timezone.utc).isoformat()],
        })
    _observe("model_save", tm)


def load_model(store, tx: int, ty: int,
               name: str = MODEL_NAME) -> forest.RandomForest | None:
    """Read a model back from the tile table (completes the reference's
    empty randomforest.read stub, ccdc/randomforest.py:21-22)."""
    rows = store.read("tile", where={"tx": int(tx), "ty": int(ty),
                                     "name": name})
    return forest.RandomForest.loads(rows["model"][0]) if rows["model"] else None


def classify_chip(model, seg: dict, aux: dict, cx: int, cy: int,
                  device=None) -> dict | None:
    """Score one chip's real segments on ``device``; returns the updated
    segment frame with rfrawp filled (ref randomforest.classify +
    segment.join, randomforest.py:90-103, segment.py:103-116)."""
    mask = features.real_rows(seg)
    if not mask.any():
        return None
    X, _ = _assemble(seg, aux, cx, cy, mask)
    with obs_metrics.timer() as tm:
        raw = model.raw_predict(X, device=device)
    _observe("predict", tm)
    rfrawp = list(seg["rfrawp"])
    for k, i in enumerate(np.flatnonzero(mask)):
        rfrawp[i] = [float(v) for v in raw[k]]   # dedensify, randomforest.py:106-123
    out = dict(seg)
    out["rfrawp"] = rfrawp
    return out


def classify_tile(x, y, *, msday: int, meday: int, acquired: str,
                  aux_source=None, store=None, number: int | None = None,
                  writer=None, device=None, counters: Counters | None = None,
                  **train_kw):
    """Full classification driver (core.py:156-251, completed).

    Trains on the 3x3 neighborhood, persists the model under the tile key,
    scores every real segment of the center tile and upserts rfrawp, on
    ``device`` (default CUDA).  Returns the trained model, or None when no
    training features exist.  ``counters`` (a fresh one unless given)
    counts the training rows, the chips classified, their segment rows and
    the real ones scored.

    ``writer`` lets a caller supply its own egress (a fleet classify job
    passes a retry-wrapped AsyncWriter over a fenced store); it is flushed
    but not closed.  The default builds a plain AsyncWriter over ``store``
    and closes it.
    """
    name = "random-forest-classification"
    log = logger(name)
    counters = Counters() if counters is None else counters
    dev = resolve_device(device)

    log.info("beginning %s... x:%s y:%s acquired:%s", name, x, y, acquired)
    model = train_tile(x, y, msday=msday, meday=meday, acquired=acquired,
                       aux_source=aux_source, store=store, number=number,
                       device=dev, counters=counters, **train_kw)
    if model is None:
        return None

    t = grid.tile(x, y)
    save_model(store, t["x"], t["y"], model)

    cids = grid.classification(x, y)
    if number is not None:
        cids = list(take(number, cids))
    own_writer = writer is None
    writer = writer if writer is not None else AsyncWriter(store)
    have = store.chip_ids("segment")
    try:
        for cx, cy in cids:
            if (int(cx), int(cy)) not in have:
                continue
            seg = _chip_segments(store, cx, cy)
            if seg is None:
                continue
            try:
                aux = aux_source.aux(cx, cy, acquired)
            except LookupError:
                continue
            updated = classify_chip(model, seg, aux, cx, cy, device=dev)
            if updated is None:
                continue
            writer.write("segment", updated)
            counters.add("chips")
            counters.add("segments", len(updated["sday"]))
            counters.add("segments_scored",
                         int(features.real_rows(updated).sum()))
    finally:
        # A caller-supplied writer outlives this call (the fleet worker
        # closes it after the queue ack decision); flush so the rfrawp
        # upserts are landed — not merely queued — before returning.
        if own_writer:
            writer.close()
        else:
            writer.flush()
        log.info("classification complete: %s", counters.snapshot())
    return model


__all__ = ["MODEL_NAME", "STAGES", "classification_stage_seconds",
           "training_data", "train_tile", "save_model", "load_model",
           "classify_chip", "classify_tile"]
