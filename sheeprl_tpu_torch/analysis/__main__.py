"""`python -m sheeprl_tpu_torch.analysis [paths...] [--json] [--rule r1,r2]` —
the same pass `sheeprl_tpu_torch lint` runs, importable without the CLI
dispatcher."""
import sys

from .engine import main

if __name__ == "__main__":
    sys.exit(main())
