"""Synthetic TPC-H-shaped data generators: the port's copy of
``examples/tpch_data.py``, which draws the same arrays from the same
``rng`` for every function and flag (numpy only).

Schema and value distributions follow the TPC-H spec shapes (lineitem with
returnflag/linestatus/shipdate, the Q5 join graph customer-orders-lineitem-
supplier-nation-region) at a parameterized scale factor, generated with
numpy instead of dbgen — the examples measure engine throughput on
realistically-shaped relational data, not spec compliance.

SF-1 lineitem is ~6M rows, matching dbgen's 6_001_215.
"""
from __future__ import annotations

import numpy as np

LINEITEM_ROWS_PER_SF = 6_000_000
ORDERS_ROWS_PER_SF = 1_500_000
CUSTOMER_ROWS_PER_SF = 150_000
SUPPLIER_ROWS_PER_SF = 10_000

NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES"]
# nation -> region assignment (nationkey order), per the spec's 5 regions
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]

# day ordinals relative to 1992-01-01; the dataset spans ~7 years
DATE_LO, DATE_HI = 0, 2556
Q1_CUTOFF = 2190  # ~1998-09-02 (1998-12-01 minus 90 days)
Q5_LO, Q5_HI = 730, 1095  # orderdate in [1994-01-01, 1995-01-01)
Q3_DATE = 1168             # 1995-03-15 (Q3's order/ship cutoff)
Q6_LO, Q6_HI = 730, 1095   # shipdate in [1994-01-01, 1995-01-01)
Q10_LO, Q10_HI = 639, 730  # orderdate in [1993-10-01, 1994-01-01)
MKTSEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
               "MACHINERY"]


def lineitem(sf: float, rng: np.random.Generator, *, q5_keys: bool = False,
             orders_rows: int | None = None):
    """Q1 columns (+ orderkey/suppkey when q5_keys) as a dict of arrays."""
    n = int(LINEITEM_ROWS_PER_SF * sf)
    d = {
        "l_quantity": rng.integers(1, 51, n).astype(np.float32),
        "l_extendedprice": (rng.random(n, np.float32) * 90000 + 900),
        "l_discount": rng.integers(0, 11, n).astype(np.float32) / 100,
        "l_tax": rng.integers(0, 9, n).astype(np.float32) / 100,
        "l_returnflag": np.array(["A", "N", "R"], object)[
            rng.integers(0, 3, n)],
        "l_linestatus": np.array(["F", "O"], object)[rng.integers(0, 2, n)],
        "l_shipdate": rng.integers(DATE_LO, DATE_HI, n).astype(np.int32),
    }
    if q5_keys:
        m = orders_rows or int(ORDERS_ROWS_PER_SF * sf)
        d["l_orderkey"] = rng.integers(0, m, n).astype(np.int32)
        d["l_suppkey"] = rng.integers(
            0, int(SUPPLIER_ROWS_PER_SF * sf), n).astype(np.int32)
    return d


def orders(sf: float, rng: np.random.Generator, *, q3_cols: bool = False):
    n = int(ORDERS_ROWS_PER_SF * sf)
    d = {
        "o_orderkey": np.arange(n, dtype=np.int32),
        "o_custkey": rng.integers(0, int(CUSTOMER_ROWS_PER_SF * sf),
                                  n).astype(np.int32),
        "o_orderdate": rng.integers(DATE_LO, DATE_HI, n).astype(np.int32),
    }
    if q3_cols:  # opt-in, see customer()
        d["o_shippriority"] = np.zeros(n, np.int32)  # spec: constant 0
    return d


def customer(sf: float, rng: np.random.Generator, *, q3_cols: bool = False):
    n = int(CUSTOMER_ROWS_PER_SF * sf)
    d = {
        "c_custkey": np.arange(n, dtype=np.int32),
        "c_nationkey": rng.integers(0, len(NATIONS), n).astype(np.int32),
    }
    if q3_cols:  # opt-in: Q1/Q5 payload widths must stay comparable
        # across rounds (spec: ~1/5 of customers per segment)
        d["c_mktsegment"] = rng.integers(0, len(MKTSEGMENTS),
                                         n).astype(np.int32)
    return d


def supplier(sf: float, rng: np.random.Generator):
    n = int(SUPPLIER_ROWS_PER_SF * sf)
    return {
        "s_suppkey": np.arange(n, dtype=np.int32),
        "s_nationkey": rng.integers(0, len(NATIONS), n).astype(np.int32),
    }


def nation():
    n = len(NATIONS)
    return {
        "n_nationkey": np.arange(n, dtype=np.int32),
        "n_regionkey": np.asarray(NATION_REGION, np.int32),
        "n_name": np.array(NATIONS, object),
    }


def region():
    return {
        "r_regionkey": np.arange(len(REGIONS), dtype=np.int32),
        "r_name": np.array(REGIONS, object),
    }
