"""`python -m flo_torch` entry point -> the flo-torch CLI."""

import sys

from .cli import main

sys.exit(main())
