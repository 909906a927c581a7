"""The benchmark's own tests run from a checkout's root: ``python -m pytest
portbench/tests``. They import ``portbench`` and the port from that root."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
