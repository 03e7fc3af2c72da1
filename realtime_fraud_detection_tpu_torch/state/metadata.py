"""Durable metadata store (SQLite): jobs, checkpoints, features, profiles.

Port of the JAX package's ``state/metadata.py`` (host-only; ``run-job
--metadata-db`` records the job and its checkpoints here).

The reference ships a three-database Postgres schema — flink_metadata
(jobs/checkpoints/savepoints), feature_store (groups/features/values with
JSONB + TTL), user_profiles (users/merchants/...) — that NOTHING in its code
ever reads or writes (docker/postgres/init.sql; JDBC configured in
JobConfig.java:27-31 but never exercised — SURVEY.md §2.5 "schema-as-
intent"). Here the same intent is implemented: a single-file SQLite store
(stdlib, no service dependency) that the job/checkpoint layer actually
records into, and that persists feature values and profiles durably.

Schema mirrors init.sql's tables, renamed for this framework:

    jobs(job_id, job_name, status, start/end, parallelism)     init.sql:22-32
    checkpoints(step, job_id, path, size, duration, status)    init.sql:34-45
    feature_groups / features / feature_values (JSON + TTL)    init.sql:59-91
    user_profiles / merchant_profiles (JSON documents)         init.sql:100-150

Timestamps are float epoch seconds. JSON columns hold ``json.dumps`` text.
Thread-safety: one connection per store, guarded by a lock (SQLite's own
serialization plus a Python-side mutex for multi-statement operations).
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional

__all__ = ["MetadataStore"]

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id TEXT PRIMARY KEY,
    job_name TEXT NOT NULL,
    status TEXT NOT NULL,
    start_time REAL,
    end_time REAL,
    parallelism INTEGER,
    checkpoints_enabled INTEGER DEFAULT 1,
    created_at REAL,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS checkpoints (
    step INTEGER,
    job_id TEXT,
    path TEXT,
    size_bytes INTEGER,
    duration_ms REAL,
    status TEXT,
    trigger_time REAL,
    completion_time REAL,
    PRIMARY KEY (job_id, step)
);
CREATE TABLE IF NOT EXISTS feature_groups (
    name TEXT PRIMARY KEY,
    description TEXT,
    version TEXT,
    schema_json TEXT,
    created_at REAL,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS features (
    name TEXT PRIMARY KEY,
    feature_group TEXT,
    data_type TEXT,
    description TEXT,
    created_at REAL
);
CREATE TABLE IF NOT EXISTS feature_values (
    entity_type TEXT,
    entity_id TEXT,
    values_json TEXT,
    event_time REAL,
    ingestion_time REAL,
    ttl_time REAL,
    PRIMARY KEY (entity_type, entity_id)
);
CREATE INDEX IF NOT EXISTS idx_feature_values_ttl
    ON feature_values(ttl_time);
CREATE TABLE IF NOT EXISTS user_profiles (
    user_id TEXT PRIMARY KEY,
    profile_json TEXT,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS merchant_profiles (
    merchant_id TEXT PRIMARY KEY,
    profile_json TEXT,
    updated_at REAL
);
"""


class MetadataStore:
    """One SQLite file holding all durable framework metadata."""

    def __init__(self, path: str | Path = ":memory:"):
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._conn = sqlite3.connect(self.path, check_same_thread=False)
        self._conn.row_factory = sqlite3.Row
        self._lock = threading.Lock()
        with self._lock, self._conn:
            self._conn.executescript(_SCHEMA)

    def close(self) -> None:
        self._conn.close()

    # ------------------------------------------------------------------ jobs
    def register_job(self, job_id: str, job_name: str, parallelism: int = 1,
                     now: Optional[float] = None) -> None:
        ts = now if now is not None else time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO jobs (job_id, job_name, status, start_time,"
                " parallelism, created_at, updated_at)"
                " VALUES (?, ?, 'RUNNING', ?, ?, ?, ?)"
                " ON CONFLICT(job_id) DO UPDATE SET status='RUNNING',"
                " start_time=excluded.start_time, updated_at=excluded.updated_at",
                (job_id, job_name, ts, parallelism, ts, ts))

    def set_job_status(self, job_id: str, status: str,
                       now: Optional[float] = None) -> None:
        ts = now if now is not None else time.time()
        end = ts if status in ("FINISHED", "FAILED", "CANCELED") else None
        with self._lock, self._conn:
            self._conn.execute(
                "UPDATE jobs SET status=?, end_time=COALESCE(?, end_time),"
                " updated_at=? WHERE job_id=?",
                (status, end, ts, job_id))

    def get_job(self, job_id: str) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT * FROM jobs WHERE job_id=?", (job_id,)).fetchone()
        return dict(row) if row else None

    # ----------------------------------------------------------- checkpoints
    def record_checkpoint(self, job_id: str, step: int, path: str,
                          size_bytes: int = 0, duration_ms: float = 0.0,
                          status: str = "COMPLETED",
                          now: Optional[float] = None) -> None:
        ts = now if now is not None else time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO checkpoints (step, job_id, path, size_bytes,"
                " duration_ms, status, trigger_time, completion_time)"
                " VALUES (?, ?, ?, ?, ?, ?, ?, ?)"
                " ON CONFLICT(job_id, step) DO UPDATE SET path=excluded.path,"
                " size_bytes=excluded.size_bytes, status=excluded.status,"
                " completion_time=excluded.completion_time",
                (step, job_id, path, size_bytes, duration_ms, status, ts, ts))

    def checkpoints(self, job_id: str) -> List[Dict[str, Any]]:
        rows = self._conn.execute(
            "SELECT * FROM checkpoints WHERE job_id=? ORDER BY step",
            (job_id,)).fetchall()
        return [dict(r) for r in rows]

    def latest_checkpoint(self, job_id: str) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT * FROM checkpoints WHERE job_id=? AND status='COMPLETED'"
            " ORDER BY step DESC LIMIT 1", (job_id,)).fetchone()
        return dict(row) if row else None

    # -------------------------------------------------------------- features
    def register_feature_group(self, name: str, description: str = "",
                               version: str = "1.0",
                               schema: Optional[Mapping[str, Any]] = None,
                               now: Optional[float] = None) -> None:
        ts = now if now is not None else time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT INTO feature_groups (name, description, version,"
                " schema_json, created_at, updated_at) VALUES (?, ?, ?, ?, ?, ?)"
                " ON CONFLICT(name) DO UPDATE SET description=excluded.description,"
                " version=excluded.version, schema_json=excluded.schema_json,"
                " updated_at=excluded.updated_at",
                (name, description, version,
                 json.dumps(dict(schema or {})), ts, ts))

    def register_feature(self, name: str, group: str = "default",
                         data_type: str = "NUMERICAL", description: str = "",
                         now: Optional[float] = None) -> None:
        ts = now if now is not None else time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO features (name, feature_group,"
                " data_type, description, created_at) VALUES (?, ?, ?, ?, ?)",
                (name, group, data_type, description, ts))

    def feature_names(self, group: Optional[str] = None) -> List[str]:
        if group is None:
            rows = self._conn.execute("SELECT name FROM features").fetchall()
        else:
            rows = self._conn.execute(
                "SELECT name FROM features WHERE feature_group=?",
                (group,)).fetchall()
        return [r["name"] for r in rows]

    def put_feature_values(self, entity_type: str, entity_id: str,
                           values: Mapping[str, Any],
                           event_time: Optional[float] = None,
                           ttl_s: float = 7_200.0,
                           now: Optional[float] = None) -> None:
        ts = now if now is not None else time.time()
        with self._lock, self._conn:
            self._conn.execute(
                "INSERT OR REPLACE INTO feature_values (entity_type,"
                " entity_id, values_json, event_time, ingestion_time,"
                " ttl_time) VALUES (?, ?, ?, ?, ?, ?)",
                (entity_type, entity_id, json.dumps(dict(values)),
                 event_time if event_time is not None else ts, ts, ts + ttl_s))

    def get_feature_values(self, entity_type: str, entity_id: str,
                           now: Optional[float] = None) -> Dict[str, Any]:
        ts = now if now is not None else time.time()
        row = self._conn.execute(
            "SELECT values_json, ttl_time FROM feature_values"
            " WHERE entity_type=? AND entity_id=?",
            (entity_type, entity_id)).fetchone()
        if row is None or (row["ttl_time"] is not None and ts >= row["ttl_time"]):
            return {}
        return json.loads(row["values_json"])

    def expire_feature_values(self, now: Optional[float] = None) -> int:
        """Drop expired rows (the reference's ttl_timestamp index intent)."""
        ts = now if now is not None else time.time()
        with self._lock, self._conn:
            cur = self._conn.execute(
                "DELETE FROM feature_values WHERE ttl_time < ?", (ts,))
            return cur.rowcount

    # -------------------------------------------------------------- profiles
    def put_profiles(self, users: Mapping[str, Mapping[str, Any]] = (),
                     merchants: Mapping[str, Mapping[str, Any]] = (),
                     now: Optional[float] = None) -> None:
        ts = now if now is not None else time.time()
        with self._lock, self._conn:
            if users:
                self._conn.executemany(
                    "INSERT OR REPLACE INTO user_profiles VALUES (?, ?, ?)",
                    [(uid, json.dumps(dict(p)), ts) for uid, p in users.items()])
            if merchants:
                self._conn.executemany(
                    "INSERT OR REPLACE INTO merchant_profiles VALUES (?, ?, ?)",
                    [(mid, json.dumps(dict(p)), ts)
                     for mid, p in merchants.items()])

    def get_user_profile(self, user_id: str) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT profile_json FROM user_profiles WHERE user_id=?",
            (user_id,)).fetchone()
        return json.loads(row["profile_json"]) if row else None

    def get_merchant_profile(self, merchant_id: str) -> Optional[Dict[str, Any]]:
        row = self._conn.execute(
            "SELECT profile_json FROM merchant_profiles WHERE merchant_id=?",
            (merchant_id,)).fetchone()
        return json.loads(row["profile_json"]) if row else None

    def load_all_profiles(self) -> Dict[str, Dict[str, Dict[str, Any]]]:
        """Bulk restore (scorer warm-start after restart)."""
        users = {r["user_id"]: json.loads(r["profile_json"])
                 for r in self._conn.execute(
                     "SELECT * FROM user_profiles").fetchall()}
        merchants = {r["merchant_id"]: json.loads(r["profile_json"])
                     for r in self._conn.execute(
                         "SELECT * FROM merchant_profiles").fetchall()}
        return {"users": users, "merchants": merchants}

    # ---------------------------------------------------------------- health
    def stats(self) -> Dict[str, int]:
        out = {}
        for table in ("jobs", "checkpoints", "feature_groups", "features",
                      "feature_values", "user_profiles", "merchant_profiles"):
            out[table] = self._conn.execute(
                f"SELECT COUNT(*) AS n FROM {table}").fetchone()["n"]
        return out
