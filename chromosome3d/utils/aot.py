"""AOT executable cache: compile once, reload across processes in ~ms.

A COMPILED executable serialized with `jax.experimental.serialize_executable`
reloads in another process without tracing or compiling, so the big solve
programs (a genome bucket, a serve bucket) can be written to disk once and
every later process skips their compile. The at-scale device-prep programs
(ops/device_prep.py) ride the same cache: a fresh process re-running a
known bucket shape skips the compile for the prep too, not just the solve.
JAX's own persistent compilation cache (utils.cache) still traces and
lowers each program; this one skips both.

Scope and invariants:
  * An executable is valid only for the exact argument shapes/dtypes/
    shardings, device topology, jaxlib version, AND SOURCE CODE it was
    compiled from. The cache key hashes all of these (including a
    fingerprint of the whole package source — any edit invalidates the
    cache, the safe direction) plus a caller tag and the static config
    repr; any mismatch is a different file.
  * Deserialization failures (version bump, stale blob) fall back to a
    fresh compile and overwrite the entry — the cache can never wedge a run.
  * Opt-in: set CHROM3D_AOT_CACHE=<dir> (or pass cache_dir) to enable.
    Scripts that enable it by default use DEFAULT_CACHE_DIR, a fixed path
    inside the checkout (listed in .gitignore).

The reference has no counterpart (CNS recompiles nothing — it is an
interpreter).
"""

from __future__ import annotations

import hashlib
import logging
import os
import pickle
import tempfile
from typing import Optional, Sequence

log = logging.getLogger("chromosome3d")

_ENV_VAR = "CHROM3D_AOT_CACHE"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".aot_cache",
)

# Per-call provenance trail: every load_or_compile appends one dict
# ({"tag", "hit", "seconds", "seq", ...}) so callers (bench.py's
# provenance fields, run_genome's phase breakdown) can attribute
# wall-clock to compile-vs-cache-load without plumbing through every
# solve signature. Bounded (drop-oldest) so a long-lived serve process
# cannot grow it — consumers therefore mark positions with the monotonic
# "seq" counter (event_mark/events_since), never a list index, which the
# truncation would silently shift.
EVENTS: list = []
_EVENTS_MAX = 256
_SEQ = 0


def _record_event(ev: dict) -> dict:
    global _SEQ
    _SEQ += 1
    ev["seq"] = _SEQ
    EVENTS.append(ev)
    del EVENTS[:-_EVENTS_MAX]
    return ev


def event_mark() -> int:
    """Opaque mark for events_since — truncation-safe (unlike len())."""
    return _SEQ


def events_since(mark: int) -> list:
    """Events recorded after `mark`. If truncation has dropped some of
    them, a sentinel entry flags the loss instead of silently
    mis-attributing other work's events."""
    out = [e for e in EVENTS if e["seq"] > mark]
    expected = _SEQ - mark
    if len(out) < expected:
        out = [{"tag": "<truncated>", "hit": None, "seconds": 0.0,
                "seq": mark, "lost": expected - len(out)}] + out
    return out


def cache_dir_from_env() -> Optional[str]:
    d = os.environ.get(_ENV_VAR, "").strip()
    return d or None


_CODE_FINGERPRINT = None


def _code_fingerprint() -> str:
    """Hash of every source file in the chromosome3d package. A
    serialized executable embeds the COMPILED code, so any solver/kernel
    edit must invalidate the cache — shapes and config alone cannot see a
    bug fix. Hashing the package source is cheap (~ms, memoized) and
    conservative: any edit anywhere invalidates everything, which is the
    safe direction for a cache of compiled programs."""
    global _CODE_FINGERPRINT
    if _CODE_FINGERPRINT is None:
        import chromosome3d

        root = os.path.dirname(os.path.abspath(chromosome3d.__file__))
        h = hashlib.sha256()
        for dirpath, _, names in sorted(os.walk(root)):
            for name in sorted(names):
                if name.endswith((".py", ".cc", ".so")):
                    p = os.path.join(dirpath, name)
                    h.update(name.encode())
                    with open(p, "rb") as f:
                        h.update(f.read())
        _CODE_FINGERPRINT = h.hexdigest()[:16]
    return _CODE_FINGERPRINT


def _abstract_sig(args) -> str:
    """Shape/dtype/sharding signature of an argument pytree (weak-typed
    scalars and numpy inputs included — anything jax would stage out).
    Device arrays contribute their sharding so programs that differ only
    in mesh layout do not collide."""
    import jax

    parts = []
    for leaf in jax.tree.leaves(args):
        shape = getattr(leaf, "shape", ())
        dtype = getattr(leaf, "dtype", type(leaf).__name__)
        sharding = getattr(leaf, "sharding", "")
        parts.append(f"{tuple(shape)}:{dtype}:{sharding}")
    return ";".join(parts)


def cache_key(tag: str, args, statics: str = "", extra: Sequence[str] = ()) -> str:
    """Hash of everything that must match for a serialized executable to be
    reusable: library versions, backend, device kind/count, the caller's
    semantic tag + static-config repr, and the argument signature."""
    import jax
    import jaxlib

    dev = jax.devices()[0]
    h = hashlib.sha256()
    for part in (
        jax.__version__,
        jaxlib.__version__,
        dev.platform,
        getattr(dev, "device_kind", "?"),
        str(jax.device_count()),
        _code_fingerprint(),
        tag,
        statics,
        _abstract_sig(args),
        *extra,
    ):
        h.update(str(part).encode())
        h.update(b"\x00")
    return h.hexdigest()[:24]


class _GuardedExec:
    """Wraps a deserialized executable: if its first invocation throws
    (backend rejected the blob at dispatch), compile fresh, retry, and
    EVICT the poisoned cache entry (otherwise every later process would
    load it, fail, and pay the full compile forever) — the cache can slow
    a run down but never break it."""

    def __init__(self, loaded, compile_fn, tag, path=None, event=None):
        self._exec = loaded
        self._compile_fn = compile_fn
        self._tag = tag
        self._path = path
        self._event = event
        self._proven = False

    def __call__(self, *args):
        if self._proven:
            return self._exec(*args)
        try:
            out = self._exec(*args)
        except Exception as e:
            log.info(
                f"AOT: cached {self._tag} executable failed at dispatch "
                f"({e!r}); recompiling"
            )
            if self._path:
                try:
                    os.remove(self._path)
                    log.info(f"AOT: evicted poisoned entry {self._path}")
                except OSError:
                    pass
            # donated inputs (the prep programs donate their (L, L) upload)
            # may already be consumed by the failed dispatch — retrying with
            # deleted buffers would surface as a confusing low-level error.
            # The poisoned entry is evicted either way, so a rerun recompiles
            # cleanly; say exactly that.
            import jax

            if any(
                getattr(leaf, "is_deleted", lambda: False)()
                for leaf in jax.tree.leaves(args)
            ):
                raise RuntimeError(
                    f"AOT: cached {self._tag} executable failed at dispatch "
                    "after consuming a donated input buffer; the cache entry "
                    "was evicted — rerun to recompile cleanly"
                ) from e
            if self._event is not None:
                # the "hit" was poisoned: record that the call actually paid
                # a fresh compile (bench provenance must not claim a cache
                # win it recompiled its way out of)
                self._event["hit"] = False
                self._event["recompiled_at_dispatch"] = True
            self._exec = self._compile_fn()
            out = self._exec(*args)
        self._proven = True
        # the recompile closure pins the example args (possibly large (L, L)
        # tensors) — drop it once the blob is proven so long-lived callers
        # (the serve cache) don't retain them
        self._compile_fn = None
        return out


def load_or_compile(
    jitted,
    args: tuple,
    tag: str,
    statics: str = "",
    cache_dir: Optional[str] = None,
):
    """Return a compiled executable for `jitted` at `args`' shapes, loading
    a serialized one from the cache when present.

    cache_dir=None (and no CHROM3D_AOT_CACHE) disables the cache: the
    plain jitted callable is returned and jax's in-process jit cache
    applies as usual. Otherwise the return value is an AOT-compiled
    executable — call it with arguments of exactly the traced shapes."""
    import time as _time

    cache_dir = cache_dir or cache_dir_from_env()
    if cache_dir is None:
        _record_event({"tag": tag, "enabled": False, "hit": None,
                       "seconds": 0.0})
        return jitted

    from jax.experimental import serialize_executable as se

    t0 = _time.perf_counter()
    key = cache_key(tag, args, statics)
    # the code fingerprint rides the FILENAME (as well as the key) so
    # pruning can distinguish "same program, older source" from sibling
    # entries of the same tag (other buckets/shapes on current source)
    path = os.path.join(
        cache_dir, f"{tag}-{_code_fingerprint()}-{key}.aotx"
    )
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            loaded = se.deserialize_and_load(*blob)
            log.info(f"AOT: loaded {tag} executable from {path}")
            event = _record_event({
                "tag": tag, "enabled": True, "hit": True,
                "seconds": _time.perf_counter() - t0, "path": path,
            })
            # some backends accept the blob but reject it at dispatch (e.g.
            # XLA:CPU is strict about host machine features); guard the
            # first invocation and recompile in place if it throws
            return _GuardedExec(
                loaded, lambda: jitted.lower(*args).compile(), tag, path,
                event=event,
            )
        except Exception as e:  # stale/corrupt/foreign blob -> recompile
            log.info(f"AOT: cache entry {path} unusable ({e!r}); recompiling")

    compiled = jitted.lower(*args).compile()
    _record_event({"tag": tag, "enabled": True, "hit": False,
                   "seconds": _time.perf_counter() - t0, "path": path})
    try:
        blob = se.serialize(compiled)
        os.makedirs(cache_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(blob, f)
        os.replace(tmp, path)  # atomic: concurrent writers race benignly
        log.info(f"AOT: saved {tag} executable to {path}")
        # prune this tag's OLDER-SOURCE entries (the dir would otherwise
        # grow by one ~15 MB blob per source edit); sibling entries from
        # the current source (other buckets/shapes) are kept. A concurrent
        # process on older code just recompiles — the cache never breaks a
        # run, it only saves one.
        keep_prefix = f"{tag}-{_code_fingerprint()}-"
        for name in os.listdir(cache_dir):
            if (
                name.startswith(f"{tag}-")
                and name.endswith(".aotx")
                and not name.startswith(keep_prefix)
            ):
                try:
                    os.remove(os.path.join(cache_dir, name))
                except OSError:
                    pass
    except Exception as e:
        log.info(f"AOT: could not serialize {tag} ({e!r}); continuing uncached")
    return compiled
