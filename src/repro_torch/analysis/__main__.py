"""``python -m repro_torch.analysis`` entry point.

Guarded, unlike a bare ``sys.exit(main())``: the port's import test
walks every module of the package, this one included, and an import
must not lint ``src`` and exit."""
import sys

from repro_torch.analysis.cli import main

if __name__ == "__main__":
    sys.exit(main())
