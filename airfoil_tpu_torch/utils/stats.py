"""Analysis counter persistence: the port's copy of
``airfoil_tpu/utils/stats.py`` (same environment variables, table and
behaviour).

Mirrors the reference's ``db_utils.py``: a ``stats`` table with a
``total_analyses`` row, incremented per successful analysis and shown on
the home page (reference db_utils.py:23-91, app.py:198-215). Uses
PostgreSQL when ``DATABASE_URL`` is set and psycopg2 is importable, falls
back to a local SQLite file otherwise, and — like the reference — degrades
to a silent no-op rather than failing an analysis over a stats hiccup.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import threading

logger = logging.getLogger(__name__)

_LOCK = threading.Lock()
_SQLITE_PATH = os.getenv(
    "AIRFOIL_TPU_STATS_PATH", os.path.expanduser("~/.airfoil_tpu_stats.db"))

__all__ = ["init_db", "increment_analysis_count", "get_analysis_count"]


def _pg_conn():
    url = os.getenv("DATABASE_URL", "")
    if not url:
        return None
    try:
        import psycopg2

        return psycopg2.connect(url)
    except Exception as e:  # pragma: no cover
        logger.debug("postgres unavailable: %s", e)
        return None


def _sqlite_conn():
    conn = sqlite3.connect(_SQLITE_PATH)
    conn.execute(
        "CREATE TABLE IF NOT EXISTS stats (name TEXT PRIMARY KEY, count INTEGER)"
    )
    conn.execute(
        "INSERT OR IGNORE INTO stats (name, count) VALUES ('total_analyses', 0)"
    )
    return conn


def init_db() -> None:
    """Create the stats table; silent no-op on any failure."""
    try:
        pg = _pg_conn()
        if pg is not None:
            with pg, pg.cursor() as cur:
                cur.execute(
                    "CREATE TABLE IF NOT EXISTS stats "
                    "(name TEXT PRIMARY KEY, count INTEGER)")
                cur.execute(
                    "INSERT INTO stats (name, count) VALUES "
                    "('total_analyses', 0) ON CONFLICT (name) DO NOTHING")
            pg.close()
            return
        with _LOCK:
            conn = _sqlite_conn()
            conn.commit()
            conn.close()
    except Exception as e:
        logger.debug("init_db no-op: %s", e)


def increment_analysis_count() -> int | None:
    """Increment and return the counter; None on failure (graceful)."""
    try:
        pg = _pg_conn()
        if pg is not None:
            with pg, pg.cursor() as cur:
                cur.execute(
                    "UPDATE stats SET count = count + 1 "
                    "WHERE name = 'total_analyses' RETURNING count")
                row = cur.fetchone()
            pg.close()
            return int(row[0]) if row else None
        with _LOCK:
            conn = _sqlite_conn()
            conn.execute(
                "UPDATE stats SET count = count + 1 "
                "WHERE name = 'total_analyses'")
            conn.commit()
            row = conn.execute(
                "SELECT count FROM stats WHERE name='total_analyses'"
            ).fetchone()
            conn.close()
            return int(row[0]) if row else None
    except Exception as e:
        logger.debug("increment no-op: %s", e)
        return None


def get_analysis_count() -> int | None:
    """Current counter value; None when unavailable."""
    try:
        pg = _pg_conn()
        if pg is not None:
            with pg, pg.cursor() as cur:
                cur.execute(
                    "SELECT count FROM stats WHERE name = 'total_analyses'")
                row = cur.fetchone()
            pg.close()
            return int(row[0]) if row else None
        with _LOCK:
            conn = _sqlite_conn()
            row = conn.execute(
                "SELECT count FROM stats WHERE name='total_analyses'"
            ).fetchone()
            conn.close()
            return int(row[0]) if row else None
    except Exception as e:
        logger.debug("get count no-op: %s", e)
        return None
