"""The benchmark's own tests: CPU only, at tiny sizes (the CLI itself needs
a card).  Run from the checkout's root: python -m pytest portbench/tests"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
