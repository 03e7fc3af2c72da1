"""Structured logging: console plus a rotating JSON file, domain helpers.

Port of the JAX package's ``obs/logs.py`` (the reference's
logging_config.py:11-219): ``setup_logging`` configures a console handler
and, with a file name, a rotating JSON file handler; ``JsonFormatter``
writes one JSON object a line, with the record's extra attributes as fields
and, while a traced microbatch is in flight on the thread, the tracer's
lead trace id and worker (``obs.tracing.set_log_context``).
"""

from __future__ import annotations

import json
import logging
import logging.config
import logging.handlers
import time
from typing import Any, Dict, Mapping, Optional

from realtime_fraud_detection_tpu_torch.obs.tracing import current_log_context

__all__ = [
    "JsonFormatter",
    "setup_logging",
    "log_prediction_result",
    "log_batch_scored",
    "log_model_event",
]

_RESERVED = set(logging.LogRecord(
    "", 0, "", 0, "", (), None).__dict__) | {"message", "asctime"}


class JsonFormatter(logging.Formatter):
    """One JSON object per line; extra record attrs become fields."""

    def __init__(self, service_name: str = ""):
        super().__init__()
        # config.service_name (reference logging_config.py service field):
        # lets one log pipeline multiplex scorer/stream-job/state-server
        self.service_name = service_name

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        if self.service_name:
            out["service"] = self.service_name
        # log / trace correlation: while a traced microbatch is in flight
        # on this thread, every JSON line carries its lead trace id (and
        # the worker origin), so the flight recorder's exemplars can be
        # found in the logs
        ctx = current_log_context()
        if ctx is not None and "trace_id" not in record.__dict__:
            out["trace_id"] = ctx["trace_id"]
            if ctx["worker"]:
                out["worker"] = ctx["worker"]
        for k, v in record.__dict__.items():
            if k not in _RESERVED and not k.startswith("_"):
                out[k] = v
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_logging(level: str = "INFO", json_file: Optional[str] = None,
                  max_bytes: int = 10 * 1024 * 1024, backups: int = 3,
                  service_name: str = "") -> None:
    """Configure root logging (reference logging_config.py:11-93).
    ``service_name`` stamps every JSON line (config.service_name)."""
    handlers: Dict[str, Any] = {
        "console": {
            "class": "logging.StreamHandler",
            "formatter": "console",
            "level": level,
        },
    }
    if json_file:
        handlers["json_file"] = {
            "class": "logging.handlers.RotatingFileHandler",
            "filename": json_file,
            "maxBytes": max_bytes,
            "backupCount": backups,
            "formatter": "json",
            "level": level,
        }
    logging.config.dictConfig({
        "version": 1,
        "disable_existing_loggers": False,
        "formatters": {
            "console": {
                "format": "%(asctime)s %(levelname)-7s %(name)s  %(message)s",
            },
            "json": {"()": f"{__name__}.JsonFormatter",
                     "service_name": service_name},
        },
        "handlers": handlers,
        "root": {"level": level, "handlers": list(handlers)},
    })


def log_prediction_result(logger: logging.Logger, transaction_id: str,
                          fraud_score: float, decision: str,
                          processing_time_ms: float,
                          extra: Optional[Mapping[str, Any]] = None) -> None:
    """Structured per-prediction log (logging_config.py:145-219 analog)."""
    logger.info(
        "prediction",
        extra={
            "event": "prediction",
            "transaction_id": transaction_id,
            "fraud_score": round(float(fraud_score), 6),
            "decision": decision,
            "processing_time_ms": round(float(processing_time_ms), 3),
            **(dict(extra) if extra else {}),
        },
    )


def log_batch_scored(logger: logging.Logger, size: int, elapsed_ms: float,
                     bucket: int) -> None:
    logger.info(
        "batch_scored",
        extra={"event": "batch_scored", "size": size, "bucket": bucket,
               "elapsed_ms": round(elapsed_ms, 3)},
    )


def log_model_event(logger: logging.Logger, model: str, event: str,
                    **fields: Any) -> None:
    """Model lifecycle events: loaded / reloaded / disabled / failed."""
    logger.info(
        "model_event",
        extra={"event": event, "model": model, "ts_wall": time.time(),
               **fields},
    )
