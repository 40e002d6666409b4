"""Bounded streaming quantile digest over fixed bucket edges.

The health monitor needs request-latency p50/p99 *while the system
runs*, over an unbounded observation stream, without unbounded memory
and without sorting anything on the hot path.  The classic answer is a
sketch (t-digest, DDSketch); the repo's answer follows the metrics
registry's histogram discipline instead: **fixed bucket edges chosen at
creation**, so the digest is

* bounded — one int per bucket, forever, regardless of stream length;
* deterministic — the same observation multiset always yields the same
  counts, the same interpolated quantiles, the same snapshot bytes
  (there is no randomized compression step to make two runs disagree);
* mergeable — two digests with identical edges add bucket-wise, the
  same property that lets sweep-worker histogram sidecars sum.

Quantiles are read back by walking the cumulative counts to the bucket
containing the target rank and interpolating linearly inside it (the
DDSketch read-out, with the first/last bucket clamped to the observed
min/max so the estimate never leaves the data's range).  Accuracy is
the bucket's relative width — the default latency edges place 4 buckets
per decade from 1µs to 100s, i.e. ~29% worst-case relative error, which
is the right trade for SLO predicates ("p99 under 500ms") that compare
against thresholds orders of magnitude apart.
"""
from __future__ import annotations

import bisect

#: default latency edges: 4 log-spaced buckets per decade, 1µs .. 100s
LATENCY_EDGES = tuple(10.0 ** (e / 4.0) for e in range(-24, 9))


class QuantileDigest:
    """Fixed-edge bucket sketch with interpolated quantile read-out.

    Bucket ``i`` counts values ``v <= edges[i]`` (``bisect_left``
    placement, matching :class:`repro_torch.obs.metrics.Histogram`); the
    last bucket is the +inf overflow.  ``merge`` requires identical edges.
    """

    __slots__ = ("edges", "counts", "count", "sum", "min", "max")

    def __init__(self, edges: tuple[float, ...] = LATENCY_EDGES):
        edges = tuple(float(e) for e in edges)
        if list(edges) != sorted(edges) or len(edges) < 1 \
                or len(set(edges)) != len(edges):
            raise ValueError(
                f"digest edges must be sorted, unique, non-empty: {edges!r}")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.edges, v)] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None

    def quantile(self, q: float) -> float | None:
        """Interpolated q-quantile estimate (None while empty).

        Deterministic and monotone in ``q``; exact for q=0 / q=1 (the
        observed min/max), bucket-interpolated in between.
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1]: {q}")
        if self.count == 0:
            return None
        assert self.min is not None and self.max is not None
        rank = q * (self.count - 1)         # 0-based fractional rank
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if cum + c > rank:
                lo = self.min if i == 0 else self.edges[i - 1]
                hi = self.max if i == len(self.edges) else self.edges[i]
                frac = min(1.0, (rank - cum + 1.0) / c)
                v = lo + (hi - lo) * frac
                return min(max(v, self.min), self.max)
            cum += c
        return self.max                     # rank beyond last bucket

    def merge(self, other: "QuantileDigest") -> "QuantileDigest":
        """Add ``other``'s buckets into this digest (identical edges)."""
        if other.edges != self.edges:
            raise ValueError(
                f"cannot merge digests with different edges: "
                f"{len(self.edges)} vs {len(other.edges)} edge(s)")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        if other.min is not None:
            self.min = other.min if self.min is None \
                else min(self.min, other.min)
        if other.max is not None:
            self.max = other.max if self.max is None \
                else max(self.max, other.max)
        return self

    # -- persistence (metrics-sidecar friendly) ------------------------------

    def snapshot(self) -> dict:
        return {"edges": list(self.edges), "counts": list(self.counts),
                "count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max}

    @classmethod
    def from_snapshot(cls, snap: dict) -> "QuantileDigest":
        d = cls(tuple(snap["edges"]))
        counts = list(snap["counts"])
        if len(counts) != len(d.counts):
            raise ValueError(
                f"digest snapshot has {len(counts)} buckets for "
                f"{len(d.edges)} edges")
        d.counts = [int(c) for c in counts]
        d.count = int(snap["count"])
        d.sum = float(snap["sum"])
        d.min = None if snap["min"] is None else float(snap["min"])
        d.max = None if snap["max"] is None else float(snap["max"])
        return d
