"""Schemas of the four RecSys'21 paper datasets, built with the port's
``Schema``.

The port's own copy of the column specs of the JAX tree's
``examples/paper_repro/datasets_configs.py``: names, cardinalities,
domains, tags and the sessions of 2 to 20 interactions. Write them as
pbtxt with

    python -m transformers4rec_tpu_torch.paper_repro.datasets_configs --out ./datasets_configs
    # → ./datasets_configs/{adressa,g1,rees46,yoochoose}/schema.pbtxt
"""

from __future__ import annotations

import argparse
import os

from ..schema import ColumnSchema, FeatureType, FloatDomain, Schema, Tags, ValueCount

SESSION_LENGTH = (2, 20)  # every paper dataset: sessions of 2..20 interactions

# (name, kind, spec, extra_tags)
#   kind "cat":  spec = cardinality (int_domain max; min is 1)
#   kind "cont": spec = (min, max) float domain
#   kind "time": event-timestamp column (float, tagged time+list only)
DATASETS = {
    "rees46": [
        ("sess_pid_seq", "cat", 390_000, ["item_id", "item"]),
        ("sess_ccid_seq", "cat", 150, ["item"]),
        ("sess_csid_seq", "cat", 1_400, ["item"]),
        ("sess_bid_seq", "cat", 7_000, ["item"]),
        ("sess_price_log_norm_seq", "cont", (0.0, 10_000.0), ["item"]),
        ("sess_relative_price_to_avg_category_seq", "cont", (-10_000.0, 10_000.0), ["item"]),
        ("sess_prod_recency_days_log_norm_seq", "cont", (-10_000.0, 10_000.0), ["item"]),
        ("sess_et_hour_sin_seq", "cont", (-1.0, 1.0), []),
        ("sess_et_hour_cos_seq", "cont", (-1.0, 1.0), []),
        ("sess_et_dayofweek_sin_seq", "cont", (-1.0, 1.0), []),
        ("sess_et_dayofweek_cos_seq", "cont", (-1.0, 1.0), []),
        ("sess_etime_seq", "time", None, []),
    ],
    "yoochoose": [
        ("item_id-list", "cat", 52_740, ["item_id", "item"]),
        ("category-list", "cat", 336, ["item"]),
        ("timestamp_age_days_norm-list", "cont", (-10_000.0, 10_000.0), ["item"]),
        ("timestamp_hour_cos-list", "cont", (-1.0, 1.0), []),
        ("timestamp_hour_sin-list", "cont", (-1.0, 1.0), []),
        ("timestamp_wd_sin-list", "cont", (-1.0, 1.0), []),
        ("timestamp_wd_cos-list", "cont", (-1.0, 1.0), []),
    ],
    "g1": [
        ("click_article_id", "cat", 365_000, ["item_id", "item"]),
        ("click_environment", "cat", 5, []),
        ("click_deviceGroup", "cat", 6, []),
        ("click_os", "cat", 21, []),
        ("click_region", "cat", 30, []),
        ("click_country", "cat", 12, []),
        ("item_age_hours_norm", "cont", (-10_000.0, 10_000.0), ["item"]),
        ("hour_sin", "cont", (-1.0, 1.0), []),
        ("hour_cos", "cont", (-1.0, 1.0), []),
        ("weekday_sin", "cont", (-1.0, 1.0), []),
        ("weekday_cos", "cont", (-1.0, 1.0), []),
        ("click_timestamp", "time", None, []),
    ],
    "adressa": [
        ("article_id", "cat", 72_933, ["item_id", "item"]),
        ("city", "cat", 1_022, []),
        ("region", "cat", 237, []),
        ("country", "cat", 70, []),
        ("os", "cat", 10, []),
        ("referrer_class", "cat", 7, []),
        ("category0_encoded", "cat", 41, ["item"]),
        ("category1_encoded", "cat", 128, ["item"]),
        ("author_encoded", "cat", 112, ["item"]),
        ("item_age_hours_norm", "cont", (-10_000.0, 10_000.0), ["item"]),
        ("hour_sin", "cont", (-1.0, 1.0), []),
        ("hour_cos", "cont", (-1.0, 1.0), []),
        ("weekday_sin", "cont", (-1.0, 1.0), []),
        ("weekday_cos", "cont", (-1.0, 1.0), []),
        ("timestamp", "time", None, []),
    ],
}


def make_schema(dataset: str) -> Schema:
    """The Schema of one paper dataset (a key of ``DATASETS``)."""
    vc = ValueCount(min=SESSION_LENGTH[0], max=SESSION_LENGTH[1])
    cols = []
    for name, kind, spec, extra in DATASETS[dataset]:
        if kind == "cat":
            cols.append(ColumnSchema.create_categorical(
                name, num_items=spec, min_index=1, value_count=vc, tags=extra))
        elif kind == "cont":
            cols.append(ColumnSchema.create_continuous(
                name, min_value=spec[0], max_value=spec[1], value_count=vc, tags=extra))
        else:  # time: a float event timestamp, tagged time+list, not continuous
            cols.append(ColumnSchema(
                name=name, type=FeatureType.FLOAT, tags=[Tags.TIME.value, Tags.LIST.value],
                value_count=vc, float_domain=FloatDomain(name=name, min=0.0, max=0.0)))
    return Schema(cols)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="./datasets_configs")
    ap.add_argument("--datasets", nargs="*", default=sorted(DATASETS))
    args = ap.parse_args(argv)
    for ds in args.datasets:
        d = os.path.join(args.out, ds)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "schema.pbtxt")
        make_schema(ds).to_proto_text_file(path)
        print(path)


if __name__ == "__main__":
    main()
