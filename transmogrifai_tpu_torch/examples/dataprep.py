"""Data preparation: event aggregation, joins and conditional readers
(counterpart of ``transmogrifai_tpu.examples.dataprep``, the same
definitions).

* ``joins_and_aggregates``: email clicks and sends, each aggregated by
  user around a cutoff date (predictors before it, responses after),
  joined on the user, and a click-through rate of the two.
* ``conditional_aggregation``: web visits aggregated per user around the
  first visit to a target landing page; users who never visit it drop.

The default paths are the reference's Email and WebVisits files, which
are not in this repository: pass files of the same schemas
(``testing.dataprep_files`` writes small seeded ones).
"""
from __future__ import annotations

import datetime as _dt

import numpy as np

from ..aggregators import CutOffTime, Sum
from ..features import FeatureBuilder
from ..readers.aggregates import (
    AggregateDataReader, AggregateParams, ConditionalDataReader,
    ConditionalParams, JoinedDataReader,
)
from ..readers.readers import CSVReader

_RES = "/root/reference/helloworld/src/main/resources"
CLICKS_PATH = f"{_RES}/EmailDataset/Clicks.csv"
SENDS_PATH = f"{_RES}/EmailDataset/Sends.csv"
WEB_VISITS_PATH = f"{_RES}/WebVisitsDataset/WebVisits.csv"

DAY_MS = 24 * 3600 * 1000


def _parse_ts(value: str) -> int:
    """'2017-09-02::09:30:00' → epoch millis (reference joda pattern
    yyyy-MM-dd::HH:mm:ss)."""
    dt = _dt.datetime.strptime(value, "%Y-%m-%d::%H:%M:%S")
    return int(dt.replace(tzinfo=_dt.timezone.utc).timestamp() * 1000)


def joins_and_aggregates(clicks_path: str = CLICKS_PATH,
                         sends_path: str = SENDS_PATH):
    """reference JoinsAndAggregates: aggregate clicks/sends per user around
    the 2017-09-04 cutoff, join, and derive CTR. Returns the joined
    FeatureTable and the feature handles."""
    num_clicks_yday = (FeatureBuilder.Real("numClicksYday")
                       .extract(lambda r: 1.0).aggregate(Sum())
                       .window(DAY_MS).as_predictor())
    num_clicks_tomorrow = (FeatureBuilder.Real("numClicksTomorrow")
                           .extract(lambda r: 1.0).aggregate(Sum())
                           .window(DAY_MS).as_response())
    num_sends_last_week = (FeatureBuilder.Real("numSendsLastWeek")
                           .extract(lambda r: 1.0).aggregate(Sum())
                           .window(7 * DAY_MS).as_predictor())

    cutoff = CutOffTime.unix_epoch(_parse_ts("2017-09-04::00:00:00"))
    clicks_reader = AggregateDataReader(
        CSVReader(clicks_path, header=False,
                  schema=["clickId", "userId", "emailId", "timeStamp"]),
        AggregateParams(cutoff=cutoff,
                        timestamp_fn=lambda r: _parse_ts(r["timeStamp"])),
        key_field="userId")
    sends_reader = AggregateDataReader(
        CSVReader(sends_path, header=False,
                  schema=["sendId", "userId", "emailId", "timeStamp"]),
        AggregateParams(cutoff=cutoff,
                        timestamp_fn=lambda r: _parse_ts(r["timeStamp"])),
        key_field="userId")

    reader = JoinedDataReader(
        clicks_reader, sends_reader, join_type="outer",
        feature_sides={"numClicksYday": "left",
                       "numClicksTomorrow": "left",
                       "numSendsLastWeek": "right"})
    features = [num_clicks_yday, num_clicks_tomorrow, num_sends_last_week]
    table = reader.generate_table(features)

    clicks = np.nan_to_num(np.asarray(table["numClicksYday"].host_values(),
                                      dtype=np.float64))
    sends = np.nan_to_num(np.asarray(
        table["numSendsLastWeek"].host_values(), dtype=np.float64))
    ctr = clicks / (sends + 1.0)
    return table, ctr


def conditional_aggregation(path: str = WEB_VISITS_PATH):
    """reference ConditionalAggregation: per user, the first visit to the
    SaveBig landing page sets the cutoff; predictors aggregate the prior
    week, responses the next day; users never meeting the condition drop."""
    num_visits_week_prior = (FeatureBuilder.RealNN("numVisitsWeekPrior")
                             .extract(lambda r: 1.0).aggregate(Sum())
                             .window(7 * DAY_MS).as_predictor())
    def _bought(r):
        v = r.get("productId")
        return 1.0 if v is not None and v == v and v != "" else 0.0  # NaN-safe

    num_purchases_next_day = (FeatureBuilder.RealNN("numPurchasesNextDay")
                              .extract(_bought)
                              .aggregate(Sum()).window(DAY_MS).as_response())

    reader = ConditionalDataReader(
        CSVReader(path, header=False,
                  schema=["userId", "url", "productId", "price",
                          "timestamp"]),
        ConditionalParams(
            target_condition=lambda r: r["url"]
            == "http://www.amazon.com/SaveBig",
            timestamp_fn=lambda r: _parse_ts(r["timestamp"]),
            response_window=DAY_MS,
            drop_if_target_condition_not_met=True),
        key_field="userId")
    return reader.generate_table([num_visits_week_prior,
                                  num_purchases_next_day])


def main():
    table, ctr = joins_and_aggregates()
    print("JoinsAndAggregates:")
    for i, k in enumerate(table.key):
        print(f"  user {k}: clicksYday="
              f"{table['numClicksYday'].host_values()[i]:.1f} "
              f"sendsLastWeek="
              f"{table['numSendsLastWeek'].host_values()[i]:.1f} "
              f"ctr={ctr[i]:.3f} clicksTomorrow="
              f"{table['numClicksTomorrow'].host_values()[i]:.1f}")
    cond = conditional_aggregation()
    print("ConditionalAggregation:")
    for i, k in enumerate(cond.key):
        print(f"  user {k}: visitsWeekPrior="
              f"{cond['numVisitsWeekPrior'].host_values()[i]:.1f} "
              f"purchasesNextDay="
              f"{cond['numPurchasesNextDay'].host_values()[i]:.1f}")
    return table, cond


if __name__ == "__main__":
    main()
