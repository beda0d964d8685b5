"""Seeded random feature data (counterpart of
``transmogrifai_tpu.testkit``)."""
from .random_data import (  # noqa: F401
    InfiniteStream, RandomBinary, RandomCurrency, RandomData, RandomDateList,
    RandomGeolocation, RandomIntegral, RandomList, RandomMap,
    RandomMultiPickList, RandomReal, RandomStream, RandomText, RandomVector,
    generator_of, random_table,
)
