"""The streaming histogram sketch (counterpart of
``transmogrifai_tpu.utils.streaming_histogram``): Ben-Haim and Tom-Tov's
fixed-size mergeable histogram (SPDT), which the raw feature filter folds
each numeric column through on the host.

The sketch is the C++ of ``csrc/streaming_histogram.cpp``, compiled with
``g++ -O2 -shared -fPIC -std=c++17`` at first use into
``transmogrifai_tpu_torch/_build/libstreaminghist-<hash>.so`` (the hash
covers the source and the flags) and bound with ``ctypes``. A failed build
raises: there is no silent fallback. ``StreamingHistogram(...,
native=False)`` is the same algorithm in numpy, reached only by that
argument; merges and compactions of the two are byte-identical, which the
tests hold.
"""
from __future__ import annotations

import bisect
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "streaming_histogram.cpp"
BUILD_DIR = _PACKAGE_DIR / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_D = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "sh_create": ([ctypes.c_int], ctypes.c_void_p),
    "sh_free": ([ctypes.c_void_p], None),
    "sh_update": ([ctypes.c_void_p, _D, ctypes.c_int64], None),
    "sh_merge": ([ctypes.c_void_p, ctypes.c_void_p], None),
    "sh_num_bins": ([ctypes.c_void_p], ctypes.c_int64),
    "sh_total": ([ctypes.c_void_p], ctypes.c_double),
    "sh_min": ([ctypes.c_void_p], ctypes.c_double),
    "sh_max": ([ctypes.c_void_p], ctypes.c_double),
    "sh_get_bins": ([ctypes.c_void_p, _D, _D], None),
    "sh_sum": ([ctypes.c_void_p, ctypes.c_double], ctypes.c_double),
    "sh_uniform": ([ctypes.c_void_p, ctypes.c_int, _D], None),
    "sh_load": ([ctypes.c_void_p, _D, _D, ctypes.c_int64, ctypes.c_double,
                 ctypes.c_double, ctypes.c_double], None),
}


def library_path() -> Path:
    digest = hashlib.sha256(Path(SOURCE).read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return Path(BUILD_DIR) / f"libstreaminghist-{digest[:12]}.so"


def load_library() -> ctypes.CDLL:
    """The sketch's shared library, compiled first if it is not built;
    raises RuntimeError when the compiler fails or is missing."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        path = library_path()
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                    capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"the streaming histogram's library did "
                                   f"not build: {e}") from e
            if proc.returncode != 0:
                if tmp.exists():
                    tmp.unlink()
                raise RuntimeError(
                    f"the streaming histogram's library did not build "
                    f"({CXX} exit {proc.returncode}):\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _LIB = lib
        return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _compress_bins(bins: List[Tuple[float, float]], max_bins: int
                   ) -> List[Tuple[float, float]]:
    """SPDT compaction of a sorted (centroid, mass) list: merge the leftmost
    smallest-gap adjacent pair until at most ``max_bins`` remain (the C++
    ``compress`` loop)."""
    if len(bins) <= max_bins:
        return list(bins)
    centers = [p for p, _ in bins]
    masses = [m for _, m in bins]
    while len(centers) > max_bins:
        j = int(np.argmin(np.diff(np.asarray(centers))))
        m = masses[j] + masses[j + 1]
        centers[j] = (centers[j] * masses[j]
                      + centers[j + 1] * masses[j + 1]) / m
        masses[j] = m
        del centers[j + 1], masses[j + 1]
    return list(zip(centers, masses))


class StreamingHistogram:
    """Fixed-size mergeable histogram sketch (SPDT): the native library, or
    its numpy twin with ``native=False``."""

    def __init__(self, max_bins: int = 100, native: bool = True):
        self.max_bins = max(2, int(max_bins))
        self.native = bool(native)
        if self.native:
            self._lib = load_library()
            self._h = ctypes.c_void_p(self._lib.sh_create(self.max_bins))
        else:
            self._bins: List[Tuple[float, float]] = []
            self._total = 0.0
            self._min = np.inf
            self._max = -np.inf

    def __del__(self):
        h = getattr(self, "_h", None)
        if getattr(self, "native", False) and h:
            self._lib.sh_free(h)
            self._h = None

    # -- updates -------------------------------------------------------------
    def update(self, values: Sequence[float]) -> "StreamingHistogram":
        """Insert every non-NaN value, one point at a time."""
        xs = np.ascontiguousarray(np.asarray(values, np.float64).ravel())
        if self.native:
            self._lib.sh_update(self._h, _dptr(xs), xs.shape[0])
        else:
            for x in xs:
                if not np.isnan(x):
                    self._insert(float(x), 1.0)
        return self

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """SPDT Merge: the union of both bin lists, equal centroids
        coalesced, then one compaction; every pairing of native and numpy
        sketches runs this same algorithm."""
        if not isinstance(other, StreamingHistogram):
            raise TypeError(f"cannot merge {type(other).__name__} into a "
                            "StreamingHistogram")
        total = self.total + other.total
        lo, hi = min(self.min, other.min), max(self.max, other.max)
        if self.native and other.native:
            self._lib.sh_merge(self._h, other._h)
        else:
            # destination first, stable by centroid: std::merge's order
            merged = sorted(self.bins() + other.bins(), key=lambda b: b[0])
            self._load_state(_compress_bins(_coalesce(merged),
                                            self.max_bins), total, lo, hi)
        self._check_invariants(total)
        return self

    def _check_invariants(self, expected_total: Optional[float] = None
                          ) -> None:
        """At most ``max_bins`` bins, the mass conserved, every centroid
        within [min, max]; raises AssertionError."""
        bins = self.bins()
        if len(bins) > self.max_bins:
            raise AssertionError(f"histogram holds {len(bins)} bins > "
                                 f"max_bins={self.max_bins}")
        if expected_total is not None and self.total != expected_total:
            raise AssertionError(f"merge lost mass: total={self.total!r} != "
                                 f"expected {expected_total!r}")
        if bins and (bins[0][0] < self.min or bins[-1][0] > self.max):
            raise AssertionError("centroids escaped the [min, max] range")

    def _load_state(self, bins: List[Tuple[float, float]], total: float,
                    lo: float, hi: float) -> None:
        """Replace the whole state (bins sorted by centroid)."""
        if self.native:
            c = np.ascontiguousarray([p for p, _ in bins], np.float64)
            m = np.ascontiguousarray([w for _, w in bins], np.float64)
            self._lib.sh_load(self._h, _dptr(c), _dptr(m), c.shape[0],
                              float(total), float(lo), float(hi))
        else:
            self._bins = list(bins)
            self._total, self._min, self._max = total, lo, hi

    # -- state and the canonical merge ----------------------------------------
    def to_state(self) -> dict:
        bins = self.bins()
        return {"max_bins": np.int64(self.max_bins),
                "centers": np.asarray([p for p, _ in bins], np.float64),
                "masses": np.asarray([m for _, m in bins], np.float64),
                "total": np.float64(self.total),
                "min": np.float64(self.min), "max": np.float64(self.max)}

    @classmethod
    def from_state(cls, state: dict, native: bool = True
                   ) -> "StreamingHistogram":
        h = cls(int(state["max_bins"]), native=native)
        bins = list(zip(np.asarray(state["centers"], np.float64).tolist(),
                        np.asarray(state["masses"], np.float64).tolist()))
        h._load_state(bins, float(state["total"]), float(state["min"]),
                      float(state["max"]))
        h._check_invariants(float(state["total"]))
        return h

    @classmethod
    def merged(cls, hists: Sequence["StreamingHistogram"],
               max_bins: Optional[int] = None,
               native: Optional[bool] = None) -> "StreamingHistogram":
        """N-way merge as a function of the multiset of input bins: sorted
        by (centroid, mass), equal centroids coalesced, one compaction.
        The result is native unless every input is numpy (or ``native``
        says otherwise)."""
        hists = list(hists)
        mb = max_bins if max_bins is not None else max(
            [h.max_bins for h in hists], default=2)
        if native is None:
            native = not hists or any(h.native for h in hists)
        pairs = [b for h in hists for b in h.bins()]
        ca = np.asarray([p for p, _ in pairs], np.float64)
        ma = np.asarray([m for _, m in pairs], np.float64)
        order = np.lexsort((ma, ca))
        out = _coalesce([(float(ca[i]), float(ma[i]))
                         for i in order.tolist()])
        total = float(ma[order].sum()) if ma.size else 0.0
        lo = min([h.min for h in hists], default=np.inf)
        hi = max([h.max for h in hists], default=-np.inf)
        result = cls(mb, native=native)
        result._load_state(_compress_bins(out, mb), total, lo, hi)
        result._check_invariants(total)
        return result

    # -- queries -------------------------------------------------------------
    def bins(self) -> List[Tuple[float, float]]:
        if not self.native:
            return list(self._bins)
        n = self._lib.sh_num_bins(self._h)
        centers = np.zeros(n, np.float64)
        masses = np.zeros(n, np.float64)
        if n:
            self._lib.sh_get_bins(self._h, _dptr(centers), _dptr(masses))
        return list(zip(centers.tolist(), masses.tolist()))

    @property
    def total(self) -> float:
        return self._lib.sh_total(self._h) if self.native else self._total

    @property
    def min(self) -> float:
        return self._lib.sh_min(self._h) if self.native else self._min

    @property
    def max(self) -> float:
        return self._lib.sh_max(self._h) if self.native else self._max

    def sum(self, b: float) -> float:
        """Estimated count of points <= b (the paper's Sum)."""
        if self.native:
            return self._lib.sh_sum(self._h, float(b))
        return self._sum(float(b))

    def quantile(self, q: float) -> float:
        """Approximate q-quantile by bisection over ``sum``."""
        if self.total == 0:
            return float("nan")
        target = q * self.total
        lo, hi = self.min, self.max
        for _ in range(60):
            mid = (lo + hi) / 2.0
            if self.sum(mid) < target:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2.0

    def uniform(self, num_bins: int) -> np.ndarray:
        """``num_bins - 1`` interior boundaries of equal-mass bins."""
        if num_bins < 2 or self.total == 0:
            return np.zeros(0, np.float64)
        if not self.native:
            return np.array([self.quantile(k / num_bins)
                             for k in range(1, num_bins)])
        out = np.zeros(num_bins - 1, np.float64)
        self._lib.sh_uniform(self._h, num_bins, _dptr(out))
        return out

    def density(self, boundaries: np.ndarray) -> np.ndarray:
        """Mass per interval of sorted edges (B + 1,) -> (B,)."""
        return np.diff(np.array([self.sum(b) for b in boundaries]))

    # -- the numpy version ---------------------------------------------------
    def _insert(self, x: float, w: float) -> None:
        i = bisect.bisect_left([p for p, _ in self._bins], x)
        if i < len(self._bins) and self._bins[i][0] == x:
            self._bins[i] = (x, self._bins[i][1] + w)
        else:
            self._bins.insert(i, (x, w))
        self._total += w
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        self._bins = _compress_bins(self._bins, self.max_bins)

    def _sum(self, b: float) -> float:
        bins = self._bins
        if not bins:
            return 0.0
        if b >= bins[-1][0]:
            if self._max > bins[-1][0] and b < self._max:
                frac = (b - bins[-1][0]) / (self._max - bins[-1][0])
                return (self._total - bins[-1][1] / 2.0
                        + bins[-1][1] / 2.0 * frac)
            return self._total
        if b < bins[0][0]:
            if self._min < bins[0][0] and b >= self._min:
                frac = (b - self._min) / (bins[0][0] - self._min)
                return bins[0][1] / 2.0 * frac
            return 0.0
        i = 0
        while i + 1 < len(bins) and bins[i + 1][0] <= b:
            i += 1
        s = 0.0
        for _, m in bins[:i]:
            s += m
        s += bins[i][1] / 2.0
        if i + 1 < len(bins) and bins[i + 1][0] > bins[i][0]:
            (pi, mi), (pj, mj) = bins[i], bins[i + 1]
            frac = (b - pi) / (pj - pi)
            mb = mi + (mj - mi) * frac
            s += (mi + mb) / 2.0 * frac
        return s


def _coalesce(sorted_bins: List[Tuple[float, float]]
              ) -> List[Tuple[float, float]]:
    """Equal adjacent centroids summed into one bin."""
    out: List[Tuple[float, float]] = []
    for p, m in sorted_bins:
        if out and out[-1][0] == p:
            out[-1] = (p, out[-1][1] + m)
        else:
            out.append((p, m))
    return out
