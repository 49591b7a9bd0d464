"""Structured logging setup.

The reference logs via bare prints (SURVEY §5).  The CLI keeps those prints
(they are part of the observable contract) and additionally emits structured
records through the ``wgsassign_tpu`` logger; library code logs here rather
than printing.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("wgsassign_tpu")


def setup_logging(level: str | None = None) -> logging.Logger:
    """Configure the package logger; level from arg or ``WGSA_LOG_LEVEL``
    (default WARNING so library use stays quiet).

    Records always propagate to the root logger (so pytest ``caplog`` and
    app-level handlers see them); our formatted stderr handler is attached
    only when the application has not configured root handlers of its own,
    which avoids double-printing in embedding applications.
    """
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S"
            )
        )
        logger.addHandler(handler)
    logger.setLevel(
        (level or os.environ.get("WGSA_LOG_LEVEL", "WARNING")).upper()
    )
    logger.propagate = True
    return logger
