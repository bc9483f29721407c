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
"""

from firebird_tpu_torch.rf.forest import RandomForest, train  # noqa: F401
