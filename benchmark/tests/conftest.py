"""The benchmark's tests import it as the package `benchmark` from the
repo's root, whatever directory pytest starts in."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
