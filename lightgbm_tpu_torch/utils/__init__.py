from .device import resolve_device
from .log import Log

__all__ = ["Log", "resolve_device"]
