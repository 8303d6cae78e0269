"""Migration pipeline: batching, retry, transforms, progress.

A copy of ``velesdb_tpu/migrate/pipeline.py``. Counterpart of ``velesdb-migrate/src/pipeline.rs`` (pipeline with
retry/transform) — stream records from a connector into a collection in
batches with exponential-backoff retry and optional transform hooks.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable

import numpy as np

__all__ = ["MigrationPipeline", "MigrationReport"]


class MigrationReport(dict):
    @property
    def migrated(self) -> int:
        return self["migrated"]

    @property
    def failed(self) -> int:
        return self["failed"]

    @property
    def skipped(self) -> int:
        return self["skipped"]


class MigrationPipeline:
    """connector.records() -> [transform] -> Collection.upsert_bulk."""

    def __init__(
        self,
        connector,
        collection,
        batch_size: int = 512,
        max_retries: int = 3,
        backoff_s: float = 0.25,
        transform: Callable[[dict], dict | None] | None = None,
        on_progress: Callable[[int], None] | None = None,
        dry_run: bool = False,
    ):
        self.connector = connector
        self.collection = collection
        self.batch_size = batch_size
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.transform = transform
        self.on_progress = on_progress
        self.dry_run = dry_run

    def run(self) -> MigrationReport:
        migrated = failed = skipped = 0
        batch: list[dict] = []
        for rec in self.connector.records():
            if self.transform is not None:
                rec = self.transform(rec)
                if rec is None:
                    skipped += 1
                    continue
            batch.append(rec)
            if len(batch) >= self.batch_size:
                ok, bad = self._flush(batch)
                migrated += ok
                failed += bad
                batch = []
                if self.on_progress:
                    self.on_progress(migrated)
        if batch:
            ok, bad = self._flush(batch)
            migrated += ok
            failed += bad
            if self.on_progress:
                self.on_progress(migrated)
        if not self.dry_run:
            self.collection.flush()
        return MigrationReport(migrated=migrated, failed=failed, skipped=skipped)

    def _flush(self, batch: list[dict]) -> tuple[int, int]:
        if self.dry_run:
            return len(batch), 0
        ids = [r["id"] for r in batch]
        vecs = np.asarray([r["vector"] for r in batch], np.float32)
        payloads = [r.get("payload") for r in batch]
        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            try:
                self.collection.upsert_bulk(ids, vecs, payloads)
                return len(batch), 0
            except ValueError:
                raise  # schema errors won't heal on retry
            except Exception:
                if attempt == self.max_retries:
                    return 0, len(batch)
                time.sleep(delay)
                delay *= 2
        return 0, len(batch)
