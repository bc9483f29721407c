"""firebird-lint for the port: repo-native static analysis of
``firebird_tpu_torch/`` (the JAX package's ``analysis/``,
docs/STATIC_ANALYSIS.md).

Three AST-checked contract families over the port's own code:

- **knob-registry** — every ``FIREBIRD_*`` env read routes through the
  port's ``config.KNOBS`` registry, is documented, and is actually read
  somewhere (dead-knob detection).
- **metrics-contract** — obs instruments satisfy the Prometheus naming
  rules, carry help text, and match the docs' metric tables (and the
  port's own table in README.md) both ways; span names and SLO
  objectives agree with their catalogs.
- **thread-ownership** — ``# guarded-by: <lock>`` annotated shared state
  is only touched under its lock.

The JAX package's jax-hotpath family has no counterpart (the port has no
jitted code); ``--rules jax-hotpath`` is refused by name.  Run with
``python -m firebird_tpu_torch lint`` or
``python -m firebird_tpu_torch.analysis``.  Stdlib ``ast`` only —
importing this package never imports torch.
"""

from firebird_tpu_torch.analysis.engine import (Baseline, Finding, LintResult,
                                                RULE_DOCS, families, main,
                                                run_lint)

__all__ = ["Baseline", "Finding", "LintResult", "RULE_DOCS", "families",
           "main", "run_lint"]
