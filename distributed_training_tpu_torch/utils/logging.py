"""Structured per-process logging: a copy of the JAX package's
``utils/logging.py`` (root logger → file + stdout, timestamped; handler
setup is idempotent)."""

from __future__ import annotations

import logging
import os
import sys

_CONFIGURED = False

FORMAT = ("%(asctime)s [%(levelname)s] p%(process)d %(name)s: "
          "%(message)s")


def setup_logging(level: str = "INFO", log_file: str | None = None,
                  process_index: int = 0, force: bool = False) -> None:
    """Configure root logging once per process.

    Non-coordinator processes log at WARNING to the console (so a pod's
    worth of workers doesn't interleave) but keep full logs in their
    per-process file — the reference's per-rank-file idea
    (ddp_script.py:70-78) applied to production.
    """
    global _CONFIGURED
    if _CONFIGURED and not force:
        return
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    root.setLevel(getattr(logging, level.upper(), logging.INFO))

    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(logging.Formatter(FORMAT))
    if process_index != 0:
        console.setLevel(logging.WARNING)
    root.addHandler(console)

    if log_file:
        base, ext = os.path.splitext(log_file)
        path = (log_file if process_index == 0
                else f"{base}.p{process_index}{ext}")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(logging.Formatter(FORMAT))
        root.addHandler(fh)
    _CONFIGURED = True
