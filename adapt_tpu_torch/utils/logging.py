"""Structured logging (a copy of ``adapt_tpu/utils/logging.py``).

Stdlib logging with a compact single-line formatter carrying
component + key=value fields, quiet by default (WARNING) so the serving hot
path never blocks on stdout; ``ADAPT_TPU_LOG=debug`` to turn up.
"""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False


def _configure_root() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    level = os.environ.get("ADAPT_TPU_LOG", "warning").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s.%(msecs)03d %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S",
        )
    )
    root = logging.getLogger("adapt_tpu_torch")
    root.addHandler(handler)
    root.setLevel(getattr(logging, level, logging.WARNING))
    root.propagate = False
    _CONFIGURED = True


def get_logger(component: str) -> logging.Logger:
    _configure_root()
    return logging.getLogger(f"adapt_tpu_torch.{component}")


def _kv_value(v) -> str:
    """One field value, quoted when unquoted rendering would be
    unparseable: spaces or ``=`` inside a bare value make ``a=x y=1``
    ambiguous to any key=value splitter, so such values (and ones
    carrying quotes/newlines, or the empty string) render as a
    double-quoted, backslash-escaped token."""
    s = str(v)
    if s and not any(
        c in s for c in (" ", "=", '"', "\\", "\n", "\r", "\t")
    ):
        return s
    s = s.replace("\\", "\\\\").replace('"', '\\"')
    s = s.replace("\n", "\\n").replace("\r", "\\r").replace("\t", "\\t")
    return f'"{s}"'


def kv(**fields) -> str:
    """Render key=value fields for structured log lines. Values that
    would break the line's key=value grammar are quoted
    (:func:`_kv_value`), so ``kv(msg="send failed", peer="a=b")`` stays
    machine-splittable on unquoted whitespace."""
    return " ".join(f"{k}={_kv_value(v)}" for k, v in fields.items())
