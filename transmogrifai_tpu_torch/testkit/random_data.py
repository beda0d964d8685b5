"""Seeded random feature data (counterpart of
``transmogrifai_tpu.testkit.random_data``, the same draws): infinite,
deterministic streams of typed values from numpy's ``RandomState``, with
``with_probability_of_empty`` injecting None, a default generator for
every feature type (``generator_of``) and ``random_table``, which builds
the port's host ``FeatureTable`` (numeric columns in one vectorized draw
each).
"""
from __future__ import annotations

import string
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np


class RandomData:
    """Infinite seeded stream (reference RandomData trait). Iterate or
    ``take(n)``; ``with_probability_of_empty(p)`` injects Nones."""

    def __init__(self, seed: int = 42):
        self._seed = int(seed)
        self._rng = np.random.RandomState(seed)
        self.probability_of_empty = 0.0

    def with_probability_of_empty(self, p: float) -> "RandomData":
        self.probability_of_empty = float(p)
        return self

    def reset(self, seed: int) -> "RandomData":
        self._seed = int(seed)
        self._rng = np.random.RandomState(seed)
        return self

    def _one(self) -> Any:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self.probability_of_empty and self._rng.rand() < self.probability_of_empty:
            return None
        return self._one()

    def take(self, n: int) -> List[Any]:
        return [next(self) for _ in range(n)]

    # fluent alias matching the reference's `limit`
    limit = take


class RandomReal(RandomData):
    """reference RandomReal: uniform/normal/poisson/exponential/gamma/
    lognormal distributions."""

    def __init__(self, dist: str = "normal", seed: int = 42, **kw):
        super().__init__(seed)
        self.dist = dist
        self.kw = kw

    @staticmethod
    def uniform(lo: float = 0.0, hi: float = 1.0, seed: int = 42) -> "RandomReal":
        return RandomReal("uniform", seed, low=lo, high=hi)

    @staticmethod
    def normal(mean: float = 0.0, sigma: float = 1.0, seed: int = 42) -> "RandomReal":
        return RandomReal("normal", seed, loc=mean, scale=sigma)

    @staticmethod
    def poisson(lam: float = 1.0, seed: int = 42) -> "RandomReal":
        return RandomReal("poisson", seed, lam=lam)

    @staticmethod
    def exponential(scale: float = 1.0, seed: int = 42) -> "RandomReal":
        return RandomReal("exponential", seed, scale=scale)

    @staticmethod
    def gamma(shape: float = 2.0, scale: float = 1.0, seed: int = 42) -> "RandomReal":
        return RandomReal("gamma", seed, shape=shape, scale=scale)

    @staticmethod
    def lognormal(mean: float = 0.0, sigma: float = 1.0, seed: int = 42) -> "RandomReal":
        return RandomReal("lognormal", seed, mean=mean, sigma=sigma)

    def _one(self) -> float:
        return float(getattr(self._rng, self.dist)(**self.kw))


class RandomIntegral(RandomData):
    """reference RandomIntegral: uniform ints or poisson counts; also epoch
    dates via ``dates``."""

    def __init__(self, lo: int = 0, hi: int = 100, seed: int = 42):
        super().__init__(seed)
        self.lo, self.hi = lo, hi

    @staticmethod
    def integers(lo: int = 0, hi: int = 100, seed: int = 42) -> "RandomIntegral":
        return RandomIntegral(lo, hi, seed)

    @staticmethod
    def dates(start_ms: int = 1_500_000_000_000, span_days: int = 365,
              seed: int = 42) -> "RandomIntegral":
        return RandomIntegral(start_ms, start_ms + span_days * 86_400_000, seed)

    def _one(self) -> int:
        return int(self._rng.randint(self.lo, self.hi))


class RandomBinary(RandomData):
    """reference RandomBinary(probabilityOfSuccess)."""

    def __init__(self, probability_of_true: float = 0.5, seed: int = 42):
        super().__init__(seed)
        self.p = probability_of_true

    def _one(self) -> bool:
        return bool(self._rng.rand() < self.p)


_FIRST_NAMES = ("james mary robert patricia john jennifer michael linda david "
                "elizabeth william barbara richard susan joseph jessica thomas "
                "sarah charles karen").split()
_LAST_NAMES = ("smith johnson williams brown jones garcia miller davis "
               "rodriguez martinez hernandez lopez gonzalez wilson anderson "
               "thomas taylor moore jackson martin").split()
_COUNTRIES = ("United States,Canada,Mexico,Brazil,France,Germany,Spain,Italy,"
              "Japan,China,India,Australia,Kenya,Egypt,Norway").split(",")
_DOMAINS = "example.com test.org mail.net company.io sample.co".split()
_WORDS = ("alpha beta gamma delta epsilon omega sigma lambda theta kappa "
          "zeta quick brown fox lazy dog lorem ipsum dolor amet").split()


class RandomText(RandomData):
    """reference RandomText: strings/names/emails/urls/countries/phones/
    picklists/ids/base64."""

    def __init__(self, kind: str = "strings", seed: int = 42,
                 domain: Optional[Sequence[str]] = None, words: int = 5):
        super().__init__(seed)
        self.kind = kind
        self.domain = list(domain) if domain is not None else None
        self.words = words

    @staticmethod
    def strings(words: int = 5, seed: int = 42) -> "RandomText":
        return RandomText("strings", seed, words=words)

    @staticmethod
    def names(seed: int = 42) -> "RandomText":
        return RandomText("names", seed)

    @staticmethod
    def emails(domain: str = "example.com", seed: int = 42) -> "RandomText":
        return RandomText("emails", seed, domain=[domain])

    @staticmethod
    def urls(seed: int = 42) -> "RandomText":
        return RandomText("urls", seed)

    @staticmethod
    def countries(seed: int = 42) -> "RandomText":
        return RandomText("countries", seed)

    @staticmethod
    def phones(seed: int = 42) -> "RandomText":
        return RandomText("phones", seed)

    @staticmethod
    def pick_lists(domain: Sequence[str], seed: int = 42) -> "RandomText":
        return RandomText("picklists", seed, domain=domain)

    @staticmethod
    def ids(seed: int = 42) -> "RandomText":
        return RandomText("ids", seed)

    @staticmethod
    def base64(seed: int = 42) -> "RandomText":
        return RandomText("base64", seed)

    def _one(self) -> str:
        r = self._rng
        if self.kind == "strings":
            k = r.randint(1, self.words + 1)
            return " ".join(r.choice(_WORDS) for _ in range(k))
        if self.kind == "names":
            return f"{r.choice(_FIRST_NAMES).title()} {r.choice(_LAST_NAMES).title()}"
        if self.kind == "emails":
            dom = r.choice(self.domain) if self.domain else r.choice(_DOMAINS)
            return f"{r.choice(_FIRST_NAMES)}.{r.choice(_LAST_NAMES)}@{dom}"
        if self.kind == "urls":
            return f"https://{r.choice(_DOMAINS)}/{r.choice(_WORDS)}"
        if self.kind == "countries":
            return str(r.choice(_COUNTRIES))
        if self.kind == "phones":
            return "+1" + "".join(str(r.randint(0, 10)) for _ in range(10))
        if self.kind == "picklists":
            return str(r.choice(self.domain))
        if self.kind == "ids":
            alphabet = np.array(list(string.ascii_uppercase + string.digits))
            return "".join(r.choice(alphabet) for _ in range(12))
        if self.kind == "base64":
            import base64
            return base64.b64encode(r.bytes(24)).decode()
        raise ValueError(self.kind)


class RandomList(RandomData):
    """reference RandomList: lists drawn from an element generator."""

    def __init__(self, element: RandomData, min_len: int = 0, max_len: int = 5,
                 seed: int = 42):
        super().__init__(seed)
        self.element = element
        self.min_len, self.max_len = min_len, max_len

    def _one(self) -> List[Any]:
        k = int(self._rng.randint(self.min_len, self.max_len + 1))
        return [v for v in self.element.take(k) if v is not None]


class RandomMultiPickList(RandomList):
    def __init__(self, domain: Sequence[str], min_len: int = 0,
                 max_len: int = 3, seed: int = 42):
        super().__init__(RandomText.pick_lists(domain, seed=seed + 1),
                         min_len, max_len, seed)

    def _one(self) -> List[str]:
        return sorted(set(super()._one()))


class RandomMap(RandomData):
    """reference RandomMap: maps of an element generator under generated keys."""

    def __init__(self, element: RandomData, keys: Sequence[str],
                 min_keys: int = 1, seed: int = 42):
        super().__init__(seed)
        self.element = element
        self.keys = list(keys)
        self.min_keys = min_keys

    def _one(self) -> Dict[str, Any]:
        k = int(self._rng.randint(self.min_keys, len(self.keys) + 1))
        chosen = list(self._rng.choice(self.keys, size=k, replace=False))
        out = {}
        for key in chosen:
            v = next(self.element)
            if v is not None:
                out[key] = v
        return out


class RandomVector(RandomData):
    """reference RandomVector: dense vectors from a real generator."""

    def __init__(self, dim: int, element: Optional[RandomReal] = None,
                 seed: int = 42):
        super().__init__(seed)
        self.dim = dim
        self.element = element or RandomReal.normal(seed=seed + 1)

    def _one(self) -> List[float]:
        return [v if v is not None else 0.0 for v in self.element.take(self.dim)]


class InfiniteStream:
    """Infinite transformed stream (reference InfiniteStream.scala:63):
    wrap an index function (``of``) or any iterator, then ``map``/``take``.

    Streams built with ``of`` are PURE VALUES like the reference's: ``map``
    returns an independent stream and the source keeps its own position.
    Streams wrapping a raw one-shot iterator cannot be re-created, so there
    ``map`` consumes the source (documented deviation)."""

    def __init__(self, it: Optional[Iterator[Any]] = None,
                 factory: Optional[Callable[[], Iterator[Any]]] = None):
        self._factory = factory
        self._it = it if it is not None else factory()

    @staticmethod
    def of(fn: Callable[[int], Any]) -> "InfiniteStream":
        import itertools
        return InfiniteStream(
            factory=lambda: (fn(i) for i in itertools.count()))

    def map(self, fn: Callable[[Any], Any]) -> "InfiniteStream":
        if self._factory is not None:  # pure value: fresh source each time
            fac = self._factory
            return InfiniteStream(factory=lambda: (fn(v) for v in fac()))
        return InfiniteStream(fn(v) for v in self._it)

    def __iter__(self) -> Iterator[Any]:
        return self._it

    def __next__(self) -> Any:
        return next(self._it)

    def take(self, n: int) -> List[Any]:
        return [next(self._it) for _ in range(n)]

    limit = take


class RandomStream(RandomData):
    """Seeded stream from an arbitrary draw function (reference
    RandomStream.scala:303 — the building block behind every Random* type):
    ``RandomStream(lambda rng: ...)``. Composes via ``map`` / ``zip``."""

    def __init__(self, draw: Callable[[np.random.RandomState], Any],
                 seed: int = 42):
        super().__init__(seed)
        self._draw = draw

    @staticmethod
    def of(draw: Callable[[np.random.RandomState], Any],
           seed: int = 42) -> "RandomStream":
        return RandomStream(draw, seed)

    @staticmethod
    def random_between(lo: float, hi: float, seed: int = 42) -> "RandomStream":
        return RandomStream(lambda r: float(r.uniform(lo, hi)), seed)

    @staticmethod
    def random_longs(lo: int, hi: int, seed: int = 42) -> "RandomStream":
        return RandomStream(lambda r: int(r.randint(lo, hi)), seed)

    def map(self, fn: Callable[[Any], Any]) -> "RandomStream":
        # child seed derives from the parent SEED, never from the parent's
        # live RNG — deriving a stream must not perturb the parent's
        # deterministic sequence
        draw = self._draw
        return RandomStream(lambda r: fn(draw(r)),
                            (self._seed * 1000003 + 1) % (2**31))

    def zip(self, other: "RandomData") -> "RandomStream":
        draw = self._draw
        return RandomStream(lambda r: (draw(r), next(other)),
                            (self._seed * 1000003 + 2) % (2**31))

    def _one(self) -> Any:
        return self._draw(self._rng)


_STREETS = ("Main St,Oak Ave,Maple Dr,Cedar Ln,Pine Rd,Elm St,2nd Ave,"
            "Park Blvd,Lake View Dr,Hill Crest Rd").split(",")
_CITIES = ("Springfield,Riverton,Fairview,Georgetown,Arlington,Ashland,"
           "Dover,Clinton,Salem,Madison").split(",")
_STATES = "CA NY TX WA OR IL MA CO GA FL".split()


class RandomGeolocation(RandomData):
    """reference RandomList.ofGeolocations: (lat, lon, accuracy) triples."""

    def __init__(self, seed: int = 42):
        super().__init__(seed)

    def _one(self) -> List[float]:
        r = self._rng
        return [float(r.uniform(-90, 90)), float(r.uniform(-180, 180)),
                float(r.randint(1, 11))]


class RandomCurrency(RandomReal):
    """reference RandomReal.currency-style positive amounts (2 decimals)."""

    def __init__(self, lo: float = 0.0, hi: float = 1000.0, seed: int = 42):
        super().__init__("uniform", seed, low=lo, high=hi)

    def _one(self) -> float:
        return round(super()._one(), 2)


class RandomDateList(RandomList):
    """reference RandomList.ofDates: sorted epoch-millis event lists."""

    def __init__(self, start_ms: int = 1_500_000_000_000,
                 span_days: int = 365, min_len: int = 0, max_len: int = 5,
                 seed: int = 42):
        super().__init__(RandomIntegral.dates(start_ms, span_days,
                                              seed=seed + 1),
                         min_len, max_len, seed)

    def _one(self) -> List[int]:
        return sorted(super()._one())


# ---------------------------------------------------------------------------
# Default generator per feature type — the testkit can produce EVERY type
# ---------------------------------------------------------------------------

def generator_of(feature_type: Any, seed: int = 42) -> RandomData:
    """A sensible default generator for any of the 52 feature types
    (reference testkit package object defaults). Text-ish types draw from
    their domain tables; maps wrap the scalar generator under keys k0..k3."""
    from ..types import FEATURE_TYPES
    name = (feature_type if isinstance(feature_type, str)
            else feature_type.__name__)
    if name not in FEATURE_TYPES:
        raise ValueError(f"unknown feature type {name!r}")
    if name.endswith("Map") and name not in ("PickListMap",):
        inner = generator_of(name[:-3], seed + 1)
        return RandomMap(inner, keys=["k0", "k1", "k2", "k3"], seed=seed)

    scalar: Dict[str, Callable[[], RandomData]] = {
        "Real": lambda: RandomReal.normal(seed=seed),
        "RealNN": lambda: RandomReal.normal(seed=seed),
        "Currency": lambda: RandomCurrency(seed=seed),
        "Percent": lambda: RandomReal.uniform(0.0, 1.0, seed=seed),
        "Integral": lambda: RandomIntegral.integers(seed=seed),
        "Date": lambda: RandomIntegral.dates(seed=seed),
        "DateTime": lambda: RandomIntegral.dates(seed=seed),
        "Binary": lambda: RandomBinary(seed=seed),
        "Text": lambda: RandomText.strings(seed=seed),
        "TextArea": lambda: RandomText.strings(words=30, seed=seed),
        "Email": lambda: RandomText.emails(seed=seed),
        "URL": lambda: RandomText.urls(seed=seed),
        "Phone": lambda: RandomText.phones(seed=seed),
        "ID": lambda: RandomText.ids(seed=seed),
        "Base64": lambda: RandomText.base64(seed=seed),
        "PickList": lambda: RandomText.pick_lists(
            ["red", "green", "blue", "yellow"], seed=seed),
        "PickListMap": lambda: RandomMap(
            RandomText.pick_lists(["red", "green", "blue"], seed=seed + 1),
            keys=["k0", "k1", "k2", "k3"], seed=seed),
        "ComboBox": lambda: RandomText.pick_lists(
            ["small", "medium", "large"], seed=seed),
        "Country": lambda: RandomText.countries(seed=seed),
        "State": lambda: RandomStream(lambda r: str(r.choice(_STATES)), seed),
        "City": lambda: RandomStream(lambda r: str(r.choice(_CITIES)), seed),
        "Street": lambda: RandomStream(
            lambda r: f"{r.randint(1, 9999)} {r.choice(_STREETS)}", seed),
        "PostalCode": lambda: RandomStream(
            lambda r: f"{r.randint(10000, 99999)}", seed),
        "TextList": lambda: RandomList(RandomText.strings(words=1,
                                                          seed=seed + 1),
                                       1, 5, seed),
        "DateList": lambda: RandomDateList(seed=seed),
        "DateTimeList": lambda: RandomDateList(seed=seed),
        "MultiPickList": lambda: RandomMultiPickList(
            ["a", "b", "c", "d"], seed=seed),
        "Geolocation": lambda: RandomGeolocation(seed=seed),
        "OPVector": lambda: RandomVector(8, seed=seed),
        "Prediction": lambda: RandomStream(
            lambda r: {"prediction": float(r.randint(0, 2))}, seed),
    }
    if name in scalar:
        return scalar[name]()
    raise ValueError(f"no default generator for feature type {name!r}")


# ---------------------------------------------------------------------------
# Benchmark-scale table builder
# ---------------------------------------------------------------------------

def random_table(spec: Dict[str, Any], n: int, seed: int = 42):
    """Build a FeatureTable from {column: FeatureType | (FeatureType, gen)}.

    Numeric scalar types draw VECTORIZED (one numpy call for all n rows), so
    benchmark-scale tables (millions of rows) build in milliseconds; host
    types fall back to the per-row generator streams."""
    from ..table import Column, FeatureTable
    from ..types import FEATURE_TYPES
    rng = np.random.RandomState(seed)
    cols: Dict[str, Any] = {}
    for i, (name, entry) in enumerate(spec.items()):
        if isinstance(entry, tuple):
            ftype, gen = entry
        else:
            ftype, gen = entry, None
        if isinstance(ftype, str):
            ftype = FEATURE_TYPES[ftype]
        kind = ftype.column_kind
        if gen is None and kind in ("real", "binary", "integral", "date"):
            # vectorized fast path end to end: build the Column directly
            # from the numpy draw (of_values' per-element loops would undo
            # the vectorization at benchmark scale)
            if kind == "real":
                vals = rng.randn(n).astype(np.float32)
            elif kind == "binary":
                vals = (rng.rand(n) < 0.5).astype(np.float32)
            elif kind == "date":
                vals = rng.randint(1_500_000_000_000,
                                   1_530_000_000_000, size=n,
                                   dtype=np.int64)
            else:
                vals = rng.randint(0, 100, size=n).astype(np.int64)
            cols[name] = Column(ftype, vals, None)
        elif gen is None and kind == "vector":
            cols[name] = Column(ftype, rng.randn(n, 8).astype(np.float32),
                                None)
        else:
            g = gen or generator_of(ftype, seed=seed + i)
            cols[name] = Column.of_values(ftype, g.take(n))
    return FeatureTable(cols, n)
