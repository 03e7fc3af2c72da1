"""Scoring service of the port (the names the JAX package's
``serving/__init__.py`` exports).

The names load on first use (a module ``__getattr__``): ``stream/job.py``
imports ``serving.validation``, and ``serving.app`` imports the cluster
plane, which imports the stream job, so importing them here would close an
import cycle.
"""

import importlib

_EXPORTS = {
    "ServingApp": "app",
    "RequestMicrobatcher": "batcher",
    "HttpError": "httpd",
    "HttpServer": "httpd",
    "NoShardAvailableError": "ingress_client",
    "ShardIngressClient": "ingress_client",
    "validate_batch": "validation",
    "validate_transaction": "validation",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
