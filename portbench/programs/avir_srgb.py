"""AVIR in sRGB gamma mode: the same call as ``programs/avir.py``, which
passes the configuration's ``use_srgb_gamma`` through; its own name picks
``reference/avir_srgb.py``."""

from .avir import make, route  # noqa: F401
