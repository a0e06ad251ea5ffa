"""Process-tagged logging (counterpart of ``tts_max_tpu/utils/logging.py``).

Every record carries hostname + process index so multi-process logs
interleave readably; non-zero processes can be silenced to ERROR.
"""

from __future__ import annotations

import logging
import socket
import sys

_FORMAT = "%(levelname).1s%(asctime)s [{host} p{rank}] %(name)s:%(lineno)d] %(message)s"


def setup_logging(process_index: int = 0, silence_nonmain: bool = True) -> logging.Logger:
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            _FORMAT.format(host=socket.gethostname(), rank=process_index),
            datefmt="%m%d %H:%M:%S",
        )
    )
    root.addHandler(handler)
    root.setLevel(
        logging.ERROR if (silence_nonmain and process_index != 0) else logging.INFO
    )
    return root


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(name)
