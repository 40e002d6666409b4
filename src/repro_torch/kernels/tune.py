"""Per-device launch-plan autotuner for the hand-written kernels.

The paper's §5.2 finding is that kernel speed is a *configuration*
problem: the winning geometry depends on the dataset's shape and the
hardware.  Each family's ``ops.py`` computes a launch plan from the shape
(``ring_plan``, ``score_plan``, ``smem_plan``, ``decode_plan``) or takes
the caller's micro-batch; this module lets a sweep on the card replace one
argument of that plan, with the reference package's content-hash cache
idiom:

* every family declares its tunable launch argument and a candidate grid
  (:data:`TUNABLES`): ``micro_batch`` for the fused SGD epochs,
  ``block_rows`` for ``glm_grad`` (rows of a ring stage or a row block)
  and ``glm_score`` (rows of a flat run), ``lanes`` for ``glm_sparse``
  (lanes a row of the smem kernel), ``splits`` for ``flash_attn`` (decode's
  key splits).  Every grid holds the plan's own pick and only
  configurations the plan's feasibility rules accept; a variant with
  nothing to tune has the single candidate ``{}``;
* :func:`tune` sweeps the candidates with ``median_time`` and persists the
  winner (and the whole timing table) on disk, keyed by ``(schema, kernel,
  backend, device kind, shape class)``: nearby shapes share a power-of-two
  **shape class**, so one sweep serves the bucket;
* each family's wrapper calls :func:`consult` when the caller does not pin
  the argument: a cached winner is applied, after a check against the
  exact shape (a winner of the class that the plan's feasibility rules
  reject there is a miss); on a miss the plan's own pick runs, unless
  ``REPRO_TORCH_KERNEL_AUTOTUNE=1``, in which case the sweep runs right
  there (never while a CUDA graph is being captured) and is cached.

:func:`lookup` is memoised in the process per (kernel, backend, exact
call): after a call's first consult, the next costs one dict lookup
(:func:`known`), so the host-bound call sites (decode, scoring flushes,
full-batch epochs) pay no file read per launch.  A memoised miss stays a
miss until :func:`tune` writes a record or :func:`forget` clears the memo,
which is also what a caller does after changing ``$REPRO_TORCH_TUNE_DIR``
or the switch.  The hit and miss counters
(``kernel.tune_cache.{hit,miss}.<family>``) count cache reads, one per
memoised call.

Cache location: ``$REPRO_TORCH_TUNE_DIR``, default
``~/.cache/repro-torch-tune``; the switch is
``REPRO_TORCH_KERNEL_AUTOTUNE``.  Neither is the reference package's
variable, so a record tuned for the TPU never reaches the card.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
from pathlib import Path
from typing import Any, Callable, Iterable

import torch

from repro_torch.kernels import common
from repro_torch.obs import metrics, trace
from repro_torch.utils.timing import median_time

#: bump when record semantics change in a way that invalidates cached winners
SCHEMA = 1

ENV_TUNE_DIR = "REPRO_TORCH_TUNE_DIR"
#: "1" -> a cache miss at an unpinned call site runs the sweep (off by
#: default: unpinned call sites then run the plan's own pick)
ENV_AUTOTUNE = "REPRO_TORCH_KERNEL_AUTOTUNE"

#: SMs of an H100 SXM: what the plans are priced at where no card is seen
H100_SMS = 132

#: memoised lookups: (cache root or None, kernel, backend, exact call) ->
#: the checked winner, or None for a miss
_MEMO: dict[tuple, dict | None] = {}
_UNSEEN = object()
_EMPTY: dict = {}


def canonical_json(obj) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _digest(obj) -> str:
    return hashlib.sha256(canonical_json(obj).encode()).hexdigest()[:16]


def tune_dir() -> Path:
    root = os.environ.get(ENV_TUNE_DIR)
    if root:
        return Path(root)
    return Path.home() / ".cache" / "repro-torch-tune"


@functools.cache
def device_kind() -> str:
    """Normalised model name of card 0 (``nvidia-h100-80gb-hbm3``), or
    ``cpu`` without a card — part of every cache key."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0).strip().lower().replace(" ", "-")


def shape_class(info: dict[str, Any]) -> dict[str, Any]:
    """Bucket every integer call-info field to the next power of two.

    ``{"n": 96, "d": 50, "dtype": "float32"}`` and ``{"n": 128, "d": 64,
    ...}`` land in the same class, so one tuning sweep serves all nearby
    shapes.  Non-integers (dtype strings, flags) pass through unchanged;
    bools are kept as bools.
    """
    out: dict[str, Any] = {}
    for k in sorted(info):
        v = info[k]
        if isinstance(v, bool) or not isinstance(v, int):
            out[k] = v
        elif v <= 0:
            out[k] = 0
        else:
            out[k] = 1 << max(0, v - 1).bit_length()
    return out


def timeable() -> bool:
    """False while a CUDA graph is being captured: a launch there only
    records, so a sweep cannot be timed and ``consult`` stays a lookup."""
    return not (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing())


def _sms() -> int:
    if torch.cuda.is_available():
        return common.sm_count(torch.device("cuda",
                                            torch.cuda.current_device()))
    return H100_SMS


# ---------------------------------------------------------------------------
# Candidate grids and feasibility, from each family's own plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Tunable:
    """One family's tunable launch argument: the plan's own pick for a
    call (``{}`` where the call's variant has nothing to tune), the sizes
    its grid tries beside the pick, the check of a configuration against
    an exact call (the plan's feasibility rules), and whether it is launch
    geometry only — which the plain versions ignore — or, as a
    micro-batch, part of the function."""

    params: tuple[str, ...]
    pick: Callable[[dict], dict]
    sizes: Callable[[dict], Iterable[int]]
    feasible: Callable[[dict, dict], bool]
    geometry: bool = True

    def candidates(self, info: dict) -> tuple[dict, ...]:
        """The grid at ``info``: the pick and every size the feasibility
        rules accept, ascending; ``({},)`` where there is nothing to tune."""
        pick = self.pick(info)
        if not pick:
            return ({},)
        (param,) = self.params
        cfgs = ({param: size}
                for size in sorted(set(self.sizes(info)) | {pick[param]}))
        return tuple(cfg for cfg in cfgs if self.feasible(info, cfg))


def _micro_batch_pick(info: dict) -> dict:
    """The caller's micro-batch where the info names one, else the
    wrappers' default."""
    from repro_torch.kernels.glm_sgd.ops import DEFAULT_MICRO_BATCH

    return {"micro_batch": info.get("micro_batch", DEFAULT_MICRO_BATCH)}


def _micro_batch_sizes(info: dict) -> list[int]:
    """Micro-batch sizes that divide N (the reference's grid); beside them
    the pick runs too, since the kernels take a ragged tail."""
    n = int(info.get("n", 0))
    return [b for b in (1, 2, 4, 8, 16, 32, 64, 128) if n and n % b == 0]


def _micro_batch_ok(info: dict, cfg: dict) -> bool:
    return cfg["micro_batch"] >= 1


def _grad_pick(info: dict) -> dict:
    """Rows of a ring stage (d <= 1,024), of a wide stage (up to 65,536)
    or of a row block (wider d), for the row layout (the col layout has no
    tiles to set)."""
    from repro_torch.kernels.glm_grad import ops

    n, d = info["n"], info["d"]
    kind = ops.variant(d, "row")
    if kind == "ring":
        return {"block_rows": ops.ring_plan(d, n, _sms())[0]}
    if kind == "wide":
        return {"block_rows": ops.wide_plan(d)[2]}
    return {"block_rows": ops.row_tile(n, _sms())}


def _grad_sizes(info: dict) -> list[int]:
    """A wide stage's rows (one exchange each, at most WIDE_MAX_ROWS);
    the ring's and the row kernel's tiles."""
    from repro_torch.kernels.glm_grad import ops

    if ops.variant(info["d"], "row") == "wide":
        return [b for b in (1, 2, 4, 8, 16, 32) if b <= ops.WIDE_MAX_ROWS]
    return [b for b in (8, 16, 32, 64, 128, 256) if b <= max(8, info["n"])]


def _grad_ok(info: dict, cfg: dict) -> bool:
    from repro_torch.kernels.glm_grad import ops

    t, d = cfg["block_rows"], info["d"]
    kind = ops.variant(d, "row")
    if kind == "ring":
        return (1 <= t <= ops.RING_MAX_TILE
                and t * ops.ring_lanes(t) <= ops.RING_CONSUMERS
                and ops.ring_smem_bytes(d, t) <= common.MAX_SMEM_BYTES)
    if kind == "wide":
        # the plan takes the rows as given only where two stages fit
        return 1 <= t <= ops.WIDE_MAX_ROWS and ops.wide_plan(d, t)[2] == t
    return 1 <= t <= ops.ROW_MAX_TILE


def _score_pick(info: dict) -> dict:
    """Rows of a flat run; the group kernel (long rows) has none."""
    from repro_torch.kernels.glm_score import ops

    n, k, d = info["n"], info["k"], info["d"]
    if ops.variant(n, k, d) != "flat":
        return {}
    return {"block_rows": ops.score_plan(n, k, _sms())[0]}


def _score_ok(info: dict, cfg: dict) -> bool:
    from repro_torch.kernels.glm_score import ops

    rows = cfg["block_rows"]
    return (ops.variant(info["n"], info["k"], info["d"]) == "flat"
            and 1 <= rows <= info["n"]
            and rows * info["k"] <= ops.RUN_WORDS - 3)


def _sparse_pick(info: dict) -> dict:
    """Lanes a row of the smem kernel; the atomic kernel has none."""
    from repro_torch.kernels.glm_sparse import ops

    if ops.variant(info["d"], info["k"], info.get("replicas", 1)) != "smem":
        return {}
    return {"lanes": ops.smem_lanes(info["k"])}


def _sparse_ok(info: dict, cfg: dict) -> bool:
    from repro_torch.kernels.glm_sparse import ops

    return (ops.variant(info["d"], info["k"], info.get("replicas", 1))
            == "smem" and cfg["lanes"] in ops.SMEM_LANES)


def _attn_decode(info: dict) -> tuple[int, int] | None:
    """``(groups, most splits)`` of a decode call, None for another
    variant: no more splits than chunks of DECODE_CHUNK_MULTIPLE keys the
    cache fills, and no more than the blocks ``decode_plan`` aims for (the
    kernel's cap)."""
    from repro_torch.kernels.flash_attn import ops

    rep = info["heads_q"] // info["heads_kv"]
    if ops.variant(getattr(torch, info["dtype"]), info["seq_q"], rep,
                   info["head_dim"]) != "decode":
        return None
    groups = ops.decode_rows(info["seq_q"] * rep)[1]
    most = min(ops.DECODE_TARGET_BLOCKS,
               -(-info["seq_k"] // ops.DECODE_CHUNK_MULTIPLE))
    return groups, most


def _attn_pick(info: dict) -> dict:
    """Decode's key splits; prefill's tiles are template constants, so
    the tensor-core and fp32 calls have none."""
    from repro_torch.kernels.flash_attn import ops

    decode = _attn_decode(info)
    if decode is None:
        return {}
    return {"splits": ops.decode_plan(info["batch"], info["heads_kv"],
                                      info["seq_k"], decode[0])[0]}


def _attn_ok(info: dict, cfg: dict) -> bool:
    """Splits of a decode call within ``_attn_decode``'s range
    (``decode_plan`` then gives each a chunk of a multiple of
    DECODE_CHUNK_MULTIPLE keys)."""
    decode = _attn_decode(info)
    return decode is not None and 1 <= cfg["splits"] <= decode[1]


def _sizes(*sizes: int) -> Callable[[dict], tuple[int, ...]]:
    return lambda info: sizes


TUNABLES: dict[str, Tunable] = {
    "glm_grad": Tunable(("block_rows",), _grad_pick, _grad_sizes, _grad_ok),
    "glm_score": Tunable(("block_rows",), _score_pick,
                         _sizes(1, 2, 4, 8, 16, 32, 64, 128), _score_ok),
    "glm_sgd": Tunable(("micro_batch",), _micro_batch_pick,
                       _micro_batch_sizes, _micro_batch_ok, geometry=False),
    "glm_sgd_sparse": Tunable(("micro_batch",), _micro_batch_pick,
                              _micro_batch_sizes, _micro_batch_ok,
                              geometry=False),
    "glm_sparse": Tunable(("lanes",), _sparse_pick, _sizes(4, 8, 16, 32),
                          _sparse_ok),
    "flash_attn": Tunable(("splits",), _attn_pick,
                          _sizes(1, 2, 4, 8, 16, 32, 64, 128, 256), _attn_ok),
}


# ---------------------------------------------------------------------------
# On-disk winner cache
# ---------------------------------------------------------------------------


class TuneCache:
    """Content-addressed winner cache: ``<root>/<key>.json`` (study idiom)."""

    def __init__(self, root: str | Path | None = None):
        self.root = Path(root) if root is not None else tune_dir()

    def key(self, kernel: str, backend: str, info: dict) -> str:
        return _digest({
            "schema": SCHEMA,
            "kernel": kernel,
            "backend": backend,
            "device_kind": device_kind(),
            "shape_class": shape_class(info),
        })

    def get(self, key: str) -> dict | None:
        try:
            with open(self.root / f"{key}.json") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def put(self, key: str, payload: dict) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = self.root / f".{key}.tmp.{os.getpid()}"
        tmp.write_text(canonical_json(payload))
        tmp.replace(self.root / f"{key}.json")  # atomic on POSIX
        forget()  # a memoised miss may now be a hit


def forget() -> None:
    """Clear the memoised lookups: the next consult of each call reads the
    cache (and ``$REPRO_TORCH_TUNE_DIR``) again."""
    _MEMO.clear()


# ---------------------------------------------------------------------------
# Tuning + call-time consultation
# ---------------------------------------------------------------------------


def lookup(kernel: str, backend: str, info, *,
           cache: TuneCache | None = None, key: tuple | None = None
           ) -> dict | None:
    """The cached winning config for this call, or None.

    Only parameters the family declares tunable are returned, so a
    stale or foreign record can never inject unexpected keywords, and a
    winner the family's feasibility rules reject at this exact call is a
    miss.  Memoised per (cache, kernel, backend, exact call): ``key``
    names the exact call where the caller has a cheaper name for it than
    ``info``'s items; ``info`` may then be a zero-argument callable that
    builds the dict, called only when the memo has no entry (a callable
    ``info`` needs a ``key``).
    """
    if key is None:
        key = tuple(sorted(info.items()))
    memo_key = (None if cache is None else cache.root, kernel, backend, key)
    cfg = _MEMO.get(memo_key, _UNSEEN)
    if cfg is _UNSEEN:
        cfg = _MEMO[memo_key] = _read(
            kernel, backend, info() if callable(info) else info, cache)
    return cfg


def _read(kernel: str, backend: str, info: dict,
          cache: TuneCache | None) -> dict | None:
    tunable = TUNABLES.get(kernel)
    if tunable is None:
        return None
    cache = cache if cache is not None else TuneCache()
    rec = cache.get(cache.key(kernel, backend, info))
    cfg = rec.get("config") if rec is not None else None
    if isinstance(cfg, dict):
        cfg = {k: v for k, v in cfg.items() if k in tunable.params}
        # a winner of the class that does not fit this exact call misses
        if not cfg or tunable.feasible(info, cfg):
            metrics.counter(f"kernel.tune_cache.hit.{kernel}").inc()
            return cfg or None
    metrics.counter(f"kernel.tune_cache.miss.{kernel}").inc()
    return None


def tune(
    kernel: str,
    backend: str,
    info: dict,
    run: Callable[..., Any],
    *,
    cache: TuneCache | None = None,
    warmup: int = 1,
    iters: int = 3,
    force: bool = False,
) -> dict:
    """Sweep the family's candidate grid and cache the fastest config.

    ``run(**config)`` must execute the kernel once with the candidate
    config and return its tensor (it is timed with a device sync).
    Returns the full record::

        {"config": {...winner...},
         "candidates": [{"config": {...}, "wall_s": ...}, ...],
         "kernel": ..., "backend": ..., "device_kind": ...,
         "shape_class": {...}, "schema": SCHEMA}

    A call with one candidate records it and no sweep (``config: {}``
    where the family has nothing to tune at this call, and for launch
    geometry on the plain versions, which ignore it).  A cached record for
    the same key short-circuits the sweep unless ``force=True``.
    """
    if kernel not in TUNABLES:
        raise KeyError(f"no tunable parameters declared for {kernel!r}; "
                       f"known: {tuple(sorted(TUNABLES))}")
    cache = cache if cache is not None else TuneCache()
    key = cache.key(kernel, backend, info)
    if not force:
        rec = cache.get(key)
        if rec is not None:
            return rec

    tunable = TUNABLES[kernel]
    candidates = tunable.candidates(info)
    if tunable.geometry and backend == common.TORCH_REFERENCE:
        candidates = ({},)   # identical launches: nothing to sweep
    if not candidates:
        raise ValueError(f"no {kernel!r} candidates for call info {info!r}")
    table = []
    if len(candidates) > 1:
        with trace.span("kernel.tune", kernel=kernel, backend=backend,
                        candidates=len(candidates)):
            for cfg in candidates:
                wall = median_time(lambda c=cfg: run(**c),
                                   warmup=warmup, iters=iters)
                table.append({"config": cfg, "wall_s": wall})
    best = (min(table, key=lambda r: r["wall_s"])["config"] if table
            else candidates[0])
    rec = {
        "schema": SCHEMA,
        "kernel": kernel,
        "backend": backend,
        "device_kind": device_kind(),
        "shape_class": shape_class(info),
        "config": best,
        "candidates": table,
    }
    cache.put(key, rec)
    return rec


def known(kernel: str, backend: str, key: tuple) -> dict | None:
    """What :func:`consult` answered for this exact call of the default
    cache, or None where it has not been consulted since the memo was last
    cleared: one dict lookup, so that a wrapper builds the closures
    ``consult`` takes only at a call's first consult."""
    cfg = _MEMO.get((None, kernel, backend, key), _UNSEEN)
    return None if cfg is _UNSEEN else cfg or _EMPTY


def consult(kernel: str, backend: str, info,
            run: Callable[..., Any] | None = None, *,
            cache: TuneCache | None = None, key: tuple | None = None) -> dict:
    """Config for an unpinned call site: cached winner, tuned, or ``{}``.

    The empty dict means "run the plan's own pick".  A sweep runs only
    when ``REPRO_TORCH_KERNEL_AUTOTUNE=1``, the caller supplied ``run``,
    and no CUDA graph is being captured.  ``info`` and ``key`` are as in
    :func:`lookup`.  The switch is read where the call's lookup is not
    memoised yet: after the first call of an exact shape, a consult is
    one dict lookup whatever it returns.  The returned dict is shared:
    read it, do not change it.
    """
    if key is None:
        key = tuple(sorted(info.items()))
    cfg = _MEMO.get((None if cache is None else cache.root, kernel, backend,
                     key), _UNSEEN)
    if cfg is _UNSEEN:
        cfg = lookup(kernel, backend, info, cache=cache, key=key)
        if cfg is None and run is not None \
                and os.environ.get(ENV_AUTOTUNE) == "1" and timeable():
            if callable(info):
                info = info()
            return dict(tune(kernel, backend, info, run,
                             cache=cache)["config"])
    return cfg or _EMPTY
