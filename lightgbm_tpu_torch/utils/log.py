"""Leveled logging (the part of the JAX package's ``utils/log.py`` the
port calls): warnings and info lines, written to stderr with the JAX
package's prefix.

Reference: ``include/LightGBM/utils/log.h:88``.
"""

from __future__ import annotations

import sys

WARNING, INFO = 0, 1


class Log:
    level: int = INFO

    @classmethod
    def warning(cls, msg: str) -> None:
        if cls.level >= WARNING:
            sys.stderr.write(f"[LightGBM-TPU] [Warning] {msg}\n")

    @classmethod
    def info(cls, msg: str) -> None:
        if cls.level >= INFO:
            sys.stderr.write(f"[LightGBM-TPU] [Info] {msg}\n")
