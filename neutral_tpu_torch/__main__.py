"""`python -m neutral_tpu_torch <deck.params>` — CLI entry point."""

import sys

from .driver import main

sys.exit(main())
