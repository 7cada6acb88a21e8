"""The native scan prefetch queue (``csrc/prefetch.c``) through ctypes.

The counterpart of ``icet_tpu/native/__init__.py``: file IO and padding
run in C producer pthreads, in order, while the consumer runs the solver
on the card.  ``ensure_built()`` compiles the source with the host C
compiler at first use (``_build.py``, into ``_build/``) and returns the
loaded library, or None when it cannot be built here.
"""

from __future__ import annotations

import ctypes
import glob
import os
import sys

import numpy as np

from icet_tpu_torch import _build

_ERRLEN = 512


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.icet_prefetch_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_long,
    ]
    lib.icet_prefetch_open.restype = ctypes.c_void_p
    lib.icet_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
    ]
    lib.icet_prefetch_next.restype = ctypes.c_int
    lib.icet_prefetch_error.argtypes = [ctypes.c_void_p]
    lib.icet_prefetch_error.restype = ctypes.c_char_p
    lib.icet_prefetch_close.argtypes = [ctypes.c_void_p]
    lib.icet_prefetch_close.restype = None
    lib.icet_load_cloud.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_char_p,
        ctypes.c_long,
    ]
    lib.icet_load_cloud.restype = ctypes.c_long
    return lib


def ensure_built(quiet: bool = True) -> ctypes.CDLL | None:
    """The loaded prefetch library, compiled first if needed; None when no
    C compiler (or no pthreads) can build it here."""
    try:
        return _bind(_build.load("prefetch"))
    except (RuntimeError, OSError) as e:
        if not quiet:
            print(f"native prefetch build failed: {e}", file=sys.stderr)
        return None


def _require() -> ctypes.CDLL:
    lib = ensure_built()
    if lib is None:
        raise RuntimeError(
            "the native prefetch queue (csrc/prefetch.c) cannot be built: "
            "no C compiler; use datasets.replay.ReplaySource"
        )
    return lib


def load_cloud(path: str, max_points: int = 131072) -> tuple[np.ndarray, int]:
    """``((max_points, 3) float32, n points read)`` by the C loaders
    (.npy float32/float64, KITTI .bin, .csv/.txt).  Raises OSError on a
    file they cannot read."""
    lib = _require()
    out = np.empty((max_points, 3), np.float32)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib.icet_load_cloud(os.fsencode(path), out.ctypes.data, max_points, err, _ERRLEN)
    if n < 0:
        raise OSError(err.value.decode(errors="replace"))
    return out, int(n)


class Prefetcher:
    """One ordered prefetch queue over ``paths``; :meth:`next_scan` pops
    the next scan, :meth:`close` joins the producers and frees the slots."""

    def __init__(self, lib: ctypes.CDLL, paths, max_points: int, n_threads: int = 2,
                 depth: int = 4, loop: bool = False, repeat: int = 0):
        self._h = None
        if not paths:
            raise ValueError("empty path list")
        self._lib = lib
        self.max_points = max_points
        # The C side copies the strings (strdup) before open returns.
        arr = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        self._h = lib.icet_prefetch_open(arr, len(paths), max_points, n_threads, depth,
                                         int(loop), repeat)
        if not self._h:
            raise RuntimeError("icet_prefetch_open failed")

    def next_scan(self) -> tuple[np.ndarray, int]:
        """Blocking ordered pop: ``((max_points, 3) float32, n points)``.
        Raises StopIteration at the end and OSError on a read error."""
        if not self._h:
            raise RuntimeError("queue closed")
        out = np.empty((self.max_points, 3), np.float32)
        n = ctypes.c_long(0)
        rc = self._lib.icet_prefetch_next(self._h, out.ctypes.data, ctypes.byref(n))
        if rc < 0:
            raise OSError(self._lib.icet_prefetch_error(self._h).decode(errors="replace"))
        if rc == 0:
            raise StopIteration
        return out, int(n.value)

    def close(self) -> None:
        if self._h:
            self._lib.icet_prefetch_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __iter__(self):
        try:
            while True:
                try:
                    scan, _n = self.next_scan()
                except StopIteration:
                    return
                yield scan
        finally:
            self.close()


def make_prefetcher(paths, max_points: int, n_threads: int = 2, depth: int = 4,
                    loop: bool = False, repeat: int = 0) -> Prefetcher:
    """A :class:`Prefetcher` over ``paths`` (raises when the queue cannot
    be built)."""
    return Prefetcher(_require(), list(paths), max_points, n_threads, depth, loop, repeat)


class NativeReplaySource:
    """Drop-in for datasets.replay.ReplaySource backed by the native ordered
    prefetch queue: file IO and padding happen in C producer threads while
    the consumer runs the solver."""

    def __init__(
        self,
        pattern: str,
        max_points: int = 131072,
        n_threads: int = 2,
        depth: int = 4,
        loop: bool = False,
        repeat: int = 0,
    ):
        _require()
        if os.path.isdir(pattern):
            pattern = os.path.join(pattern, "*")
        self.paths = sorted(
            p
            for p in glob.glob(pattern)
            if os.path.isfile(p)
            and os.path.splitext(p)[1] in (".npy", ".bin", ".csv", ".txt")
        )
        if not self.paths:
            raise FileNotFoundError(
                f"no .npy/.bin/.csv/.txt files match {pattern}"
            )
        self._args = dict(
            paths=self.paths,
            max_points=max_points,
            n_threads=n_threads,
            depth=depth,
            loop=loop,
            repeat=repeat,
        )

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        return iter(make_prefetcher(**self._args))
