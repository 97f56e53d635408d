"""Entry point: ``python -m repro_torch.analysis``."""
import sys

from repro_torch.analysis.run import main

if __name__ == "__main__":
    sys.exit(main())
