"""``python -m repro_torch.scenarios``: the scenario runner CLI
(``repro_torch.scenarios.run``)."""
import sys

from repro_torch.scenarios.run import main

if __name__ == "__main__":
    sys.exit(main())
