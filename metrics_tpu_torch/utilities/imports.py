"""Optional-dependency probing (counterpart of ``metrics_tpu/utilities/imports.py``).

The port's own copy: only the host-side audio backends are gated; torch and
numpy are hard dependencies and never probed.
"""
import importlib.util


def _package_available(name: str) -> bool:
    """True if ``name`` is importable."""
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
