"""Leveled logger — counterpart of `gmat_tpu/utils/logger.py`, the rebuild
of metrans simplelogger (Logger.h:84-291).

Same surface: TRACE..FATAL levels, console/file/UDP sinks, and a LOG(level)
call style.  Python's logging does the heavy lifting; the UDP sink matches
the reference's datagram-per-line behavior.  The port logs under its own
logger name, so configuring it leaves the JAX package's sinks alone.
"""
from __future__ import annotations

import logging
import logging.handlers
import socket
import sys

TRACE = 5
DEBUG = logging.DEBUG
INFO = logging.INFO
WARN = logging.WARNING
ERROR = logging.ERROR
FATAL = logging.CRITICAL

logging.addLevelName(TRACE, "TRACE")

_logger = logging.getLogger("gmat_tpu_torch")
_logger.setLevel(INFO)
_logger.propagate = False     # we own our handlers: records must not
_configured = False           # duplicate through a configured root logger


class _UdpSink(logging.Handler):
    """One UDP datagram per log line (Logger.h UdpOstream analog)."""

    def __init__(self, host: str, port: int):
        super().__init__()
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def emit(self, record):
        try:
            self.sock.sendto((self.format(record) + "\n").encode(), self.addr)
        except Exception:
            # stdlib convention: a bad %-format (or network error) must
            # not crash the CALLER of logger.error — report and continue
            self.handleError(record)

    def close(self):
        try:
            self.sock.close()
        finally:
            super().close()


_FMT = logging.Formatter(
    "[%(levelname)s][%(asctime)s] %(message)s", "%H:%M:%S")


def setup(level: int = INFO, console: bool = True, file: str = "",
          udp: tuple | None = None) -> None:
    """Configure sinks (console/file/UDP), replacing previous config."""
    global _configured
    for h in list(_logger.handlers):
        _logger.removeHandler(h)
        h.close()      # release file descriptors / UDP sockets
    _logger.setLevel(level)
    if console:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_FMT)
        _logger.addHandler(h)
    if file:
        h = logging.FileHandler(file)
        h.setFormatter(_FMT)
        _logger.addHandler(h)
    if udp:
        h = _UdpSink(*udp)
        h.setFormatter(_FMT)
        _logger.addHandler(h)
    _configured = True


def log(level: int, msg: str, *args) -> None:
    if not _configured:
        setup()
    _logger.log(level, msg, *args)


def trace(msg, *a): log(TRACE, msg, *a)
def debug(msg, *a): log(DEBUG, msg, *a)
def info(msg, *a): log(INFO, msg, *a)
def warn(msg, *a): log(WARN, msg, *a)
def error(msg, *a): log(ERROR, msg, *a)
def fatal(msg, *a): log(FATAL, msg, *a)
