"""Structured serving access log: one JSONL record a finished request.

Counterpart of ``bigdl_tpu/obs/access_log.py`` (stdlib only). Every
completed or failed request appends one record::

    {trace_id, tenant, phase, prompt_tokens, output_tokens,
     ttft_ms, e2e_ms, flops, outcome}

``outcome`` is ``ok``, ``timeout``, ``poisoned``, ``aborted`` or (the
fleet router's) ``rejected``; ``phase`` is where the request ended
(``queue`` before admission, ``decode`` after, ``route`` at the router).
Enabled by pointing ``BIGDL_ACCESS_LOG`` at a directory; the file
``access-<pid>.jsonl`` rotates at ``BIGDL_ACCESS_LOG_ROTATE_MB`` megabytes
(default 64). A write failure disables the log with one event and never
fails a request. The port's engine writes ``flops`` as None: the
per-program FLOPs come with the MFU accounting (ROADMAP Queue A.6).

:func:`to_bdlrec` re-shards the records into ``.bdlrec`` files for a
streaming dataset, byte for byte as JAX's does.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from typing import Optional

from bigdl_tpu_torch.obs import trace

_LOG: Optional["AccessLog"] = None
_LOG_LOCK = threading.Lock()
_ENV_SEEN: Optional[str] = None

#: record fields, in this order
FIELDS = ("trace_id", "tenant", "phase", "prompt_tokens", "output_tokens",
          "ttft_ms", "e2e_ms", "flops", "outcome")


class AccessLog:
    """Size-rotated JSONL request log in one directory."""

    def __init__(self, directory: str, rotate_mb: float = 64.0):
        self.directory = directory
        self.rotate_bytes = max(int(rotate_mb * 1024 * 1024), 4096)
        self.path = os.path.join(directory,
                                 "access-%d.jsonl" % os.getpid())
        self.records = 0
        self.rotations = 0
        self.disabled = False
        self._lock = threading.Lock()
        self._f = None

    def log(self, **fields) -> None:
        """Append one record (missing FIELDS become None; other keywords
        ride along). Never raises."""
        if self.disabled:
            return
        rec = {k: fields.pop(k, None) for k in FIELDS}
        rec.update(fields)
        line = json.dumps(rec, separators=(",", ":"), default=str) + "\n"
        try:
            with self._lock:
                if self._f is None:
                    os.makedirs(self.directory, exist_ok=True)
                    self._f = open(self.path, "a")
                self._f.write(line)
                self._f.flush()
                self.records += 1
                if self._f.tell() >= self.rotate_bytes:
                    self._rotate_locked()
        except Exception as exc:
            self.disabled = True
            trace.event("access_log_disabled", path=self.path,
                        error=str(exc))
            logging.getLogger("bigdl_tpu_torch.obs").error(
                "access log write to %s failed (%s); request logging "
                "disabled for this process", self.path, exc)

    def _rotate_locked(self) -> None:
        self._f.close()
        self._f = None
        self.rotations += 1
        rotated = self.path[:-len(".jsonl")] + "-%d.jsonl" % self.rotations
        os.replace(self.path, rotated)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


def from_env() -> Optional[AccessLog]:
    """The process's log when ``BIGDL_ACCESS_LOG`` names a directory, else
    None (allocating nothing); re-reads the variable when it changes."""
    global _LOG, _ENV_SEEN
    raw = os.environ.get("BIGDL_ACCESS_LOG", "").strip()
    with _LOG_LOCK:
        if raw != _ENV_SEEN:
            if _LOG is not None:
                _LOG.close()
            _ENV_SEEN = raw
            if raw:
                try:
                    mb = float(os.environ.get(
                        "BIGDL_ACCESS_LOG_ROTATE_MB", "64") or "64")
                except ValueError:
                    mb = 64.0
                _LOG = AccessLog(raw, rotate_mb=mb)
            else:
                _LOG = None
        return _LOG


def log_request(**fields) -> None:
    """Record one finished request when the log is on; free when off."""
    log = from_env()
    if log is not None:
        log.log(**fields)


def reset() -> None:
    """Test isolation: close and forget the process's log."""
    global _LOG, _ENV_SEEN
    with _LOG_LOCK:
        if _LOG is not None:
            _LOG.close()
        _LOG = None
        _ENV_SEEN = None


def access_record_decoder(payload: bytes) -> dict:
    """A record's JSON line back to the record."""
    return json.loads(payload.decode("utf-8"))


def to_bdlrec(log_dir: str, out_dir: str, shards: int = 1,
              prefix: str = "access") -> "tuple[list, int]":
    """Re-shard every access-log record under ``log_dir`` (all ``*.jsonl``
    files, rotated generations included, in name order) into ``shards``
    ``.bdlrec`` files under ``out_dir``, round-robin. Returns
    ``(shard_paths, count)``. Blank and torn lines are skipped; a record's
    payload is its exact JSON line, so the round trip is byte-faithful."""
    from bigdl_tpu_torch.dataset.recordio import RecordWriter

    shards = max(int(shards), 1)
    names = sorted(n for n in os.listdir(log_dir) if n.endswith(".jsonl"))
    os.makedirs(out_dir, exist_ok=True)
    paths = [os.path.join(out_dir, "%s-%05d.bdlrec" % (prefix, s))
             for s in range(shards)]
    writers = [RecordWriter(p) for p in paths]
    n = 0
    try:
        for name in names:
            with open(os.path.join(log_dir, name), "rb") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        json.loads(line.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        continue   # the torn tail of a crashed writer
                    writers[n % shards].write(line)
                    n += 1
    finally:
        for w in writers:
            w.close()
    return paths, n
