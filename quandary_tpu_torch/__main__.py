"""python -m quandary_tpu_torch <config.cfg> [--quiet] [--device cpu]"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
