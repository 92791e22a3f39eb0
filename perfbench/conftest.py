import pathlib
import sys

# the port, for tests run without PYTHONPATH=src
_SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)
