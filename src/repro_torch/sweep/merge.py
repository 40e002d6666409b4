"""Trial-cache merge: union per-worker cache roots into the canonical one.

The port's copy of the reference package's merge (stdlib-only, copied
rather than imported so the port stands alone).

Every worker in a distributed sweep owns a **private** trial-cache root
(one JSON file per ``TrialSpec.key``, written atomically by the study
runner).  After the workers finish — or die — ``merge_caches`` unions
those roots into the canonical cache:

* **idempotent** — a key whose payload bytes already match the
  destination (or an earlier source) is skipped, so re-merging a root,
  merging overlapping roots from a retried shard, or re-running a
  finished sweep is a no-op;
* **conflict-detecting** — the same key with *different* payload bytes
  is never silently resolved.  Trial payloads embed wall-clock epoch
  timings, so two executions of one key never byte-match: a conflict
  means two workers actually computed the same trial (a planner or
  requeue bug) or the canonical cache already held a different result.
  All conflicts are collected and raised together as ``MergeConflict``
  with every conflicting key and the file pair that disagrees.

Payloads are compared as bytes, not parsed JSON: every writer goes
through ``spec.canonical_json`` so equal results are equal bytes, and
byte identity is the invariant the sweep's smoke runs assert end-to-end
(merged cache ⇒ byte-identical ``BENCH_study.json``).
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Iterable, Sequence


@dataclasses.dataclass(frozen=True)
class Conflict:
    """One same-key/different-payload collision found during a merge."""

    key: str
    ours: Path      # file already merged (destination or earlier source)
    theirs: Path    # file that disagrees

    def __str__(self) -> str:
        return f"{self.key}: {self.ours} != {self.theirs}"


class MergeConflict(RuntimeError):
    """Same trial key, different payload bytes — never auto-resolved."""

    def __init__(self, conflicts: Sequence[Conflict]):
        self.conflicts = tuple(conflicts)
        self.keys = tuple(c.key for c in self.conflicts)
        lines = "\n  ".join(str(c) for c in self.conflicts)
        super().__init__(
            f"{len(self.conflicts)} trial-cache merge conflict(s) "
            f"(same key, different payload):\n  {lines}")


@dataclasses.dataclass
class MergeReport:
    """What one ``merge_caches`` call did."""

    merged: int = 0         # new keys copied into the destination
    identical: int = 0      # keys skipped because the bytes already matched
    sources: int = 0        # source roots scanned

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def cache_entries(root: str | Path) -> list[Path]:
    """The ``<key>.json`` payload files of one cache root (no tmp files).

    The one definition of "completed trial on disk" — the executor's
    dead-worker diagnosis and the merge scan must agree on it.
    """
    root = Path(root)
    if not root.is_dir():
        return []
    return sorted(p for p in root.iterdir()
                  if p.suffix == ".json" and not p.name.startswith("."))


def merge_caches(sources: Iterable[str | Path],
                 dest: str | Path) -> MergeReport:
    """Union per-worker cache roots into ``dest``; raise on conflicts.

    Scans every source (missing/empty roots are fine — a worker that
    died before its first trial has nothing to contribute), validates
    the whole union before writing anything, then copies new keys into
    ``dest`` atomically.  Conflict detection is all-or-nothing: if any
    key disagrees, ``MergeConflict`` lists every collision and ``dest``
    is left untouched.
    """
    dest = Path(dest)
    report = MergeReport()
    chosen: dict[str, tuple[Path, bytes]] = {}
    conflicts: list[Conflict] = []

    for src in sources:
        src = Path(src)
        report.sources += 1
        for path in cache_entries(src):
            key = path.stem
            data = path.read_bytes()
            dest_path = dest / path.name
            if key not in chosen and dest_path.exists():
                chosen[key] = (dest_path, dest_path.read_bytes())
            if key in chosen:
                prev_path, prev = chosen[key]
                if prev == data:
                    report.identical += 1
                else:
                    conflicts.append(Conflict(key, prev_path, path))
                continue
            chosen[key] = (path, data)

    if conflicts:
        raise MergeConflict(conflicts)

    dest.mkdir(parents=True, exist_ok=True)
    for key, (path, data) in sorted(chosen.items()):
        if path.parent == dest:
            continue    # already canonical
        tmp = dest / f".{key}.tmp.{os.getpid()}"
        tmp.write_bytes(data)
        tmp.replace(dest / f"{key}.json")   # atomic on POSIX
        report.merged += 1
    return report
