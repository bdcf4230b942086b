"""The configuration as plain data: the ``slam_config`` object of a
configuration file as nested namespaces (the reference reads the same
numbers the port is given, and nothing of the port)."""

from __future__ import annotations

from types import SimpleNamespace


def namespace(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: namespace(v) if isinstance(v, dict) else v
                              for k, v in d.items()})
