"""``python -m linkpred_tpu_torch``: the experiment driver's entry point."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
