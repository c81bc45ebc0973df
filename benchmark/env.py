"""Where the program's builds and kernel caches go: fixed directories
inside the checkout (``build/``), so that only a checkout's first run
builds and compiles.  Set before the program is imported."""

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def pin_caches() -> None:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
