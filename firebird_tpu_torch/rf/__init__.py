"""Random-forest land-cover classification: the port's own copy of the
JAX package's ``rf`` (which replaces ccdc/randomforest.py,
ccdc/features.py, ccdc/udfs.py and the predict/persist path the reference
left commented out at ccdc/core.py:190-240).

- :mod:`firebird_tpu_torch.rf.features` — the 33-column feature contract.
- :mod:`firebird_tpu_torch.rf.forest` — the random forest in PyTorch:
  histogram-based level-wise training and batched inference on the card.
- :mod:`firebird_tpu_torch.rf.prng` — the JAX package's threefry draws,
  so a seed trains the same forest in both packages.
- :mod:`firebird_tpu_torch.rf.pipeline` — train / classify orchestration
  against the keyed store.
- :mod:`firebird_tpu_torch.rf.tilemodel` — the stored model's format and
  class order, read with numpy alone (the serving layer's ``cover``).

``RandomForest`` and ``train`` load :mod:`~firebird_tpu_torch.rf.forest`
(and torch) on first use, so importing ``rf.features`` or
``rf.tilemodel`` stays host-only.
"""

__all__ = ["RandomForest", "train"]


def __getattr__(name):
    if name in __all__:
        from firebird_tpu_torch.rf import forest

        return getattr(forest, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
