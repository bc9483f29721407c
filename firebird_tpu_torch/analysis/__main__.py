"""``python -m firebird_tpu_torch.analysis`` — the port's firebird-lint
entry point (``python -m firebird_tpu_torch lint`` delegates here)."""

import sys

from firebird_tpu_torch.analysis.engine import main

if __name__ == "__main__":
    sys.exit(main())
