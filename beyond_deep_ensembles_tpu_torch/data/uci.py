"""Where the data sets live.

The part of ``beyond_deep_ensembles_tpu/data/uci.py`` that the ported loaders
share; the UCI regression sets themselves are not ported yet.
"""
from __future__ import annotations

import os


def data_dir() -> str:
    """``$BDE_DATA_DIR``, else ``./data``."""
    return os.environ.get("BDE_DATA_DIR", os.path.join(os.getcwd(), "data"))
