"""Observability for the port: the counter registry the one-sync and
kernel-launch contracts are read from."""

from . import metrics  # noqa: F401
