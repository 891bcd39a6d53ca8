"""The generators: one seed gives the same tables, and the TPC-H one keeps
the specification's derivations."""
import json

import pytest
import torch

from benchmark import harness
from benchmark.data import join_groupby, tpch

from .conftest import SEED

TPCH = {**json.loads((harness.ROOT / "benchmark/configs/tpch-sf10.json")
                     .read_text()), "scale_factor": 0.002}


def flat(tables):
    for t, cols in sorted(tables.items()):
        for c, v in sorted(cols.items()):
            for i, x in enumerate(v if isinstance(v, tuple) else (v,)):
                yield f"{t}.{c}.{i}", x


@pytest.mark.parametrize("gen,cfg", [
    (tpch, TPCH),
    (join_groupby, {"rows_per_side": 1000, "key_domain": 1000,
                    "shape_seed": 0})])
def test_same_seed_same_tables(gen, cfg):
    a = dict(flat(gen.generate(cfg, SEED, "cpu")))
    b = dict(flat(gen.generate(cfg, SEED, "cpu")))
    c = dict(flat(gen.generate(cfg, SEED + 1, "cpu")))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a
               if a[k].shape == c[k].shape and a[k].numel() > 100)


def test_join_groupby_ranges():
    d = join_groupby.generate({"rows_per_side": 5000, "key_domain": 700,
                               "shape_seed": 0}, SEED, "cpu")
    for side in d.values():
        assert side["k"].dtype == torch.int32
        assert int(side["k"].min()) >= 0 and int(side["k"].max()) < 700
        assert side["v"].dtype == torch.float32
        assert float(side["v"].min()) >= 0 and float(side["v"].max()) < 1


def test_join_groupby_same_work_for_every_seed():
    """Seeds relabel and reorder the keys: the join and group counts, and
    so every size the program derives, stay the same."""
    cfg = {"rows_per_side": 5000, "key_domain": 5000, "shape_seed": 0}

    def counts(seed):
        d = join_groupby.generate(cfg, seed, "cpu")
        cl, cr = (torch.bincount(d[s]["k"].long(), minlength=5000)
                  for s in ("left", "right"))
        return int((cl * cr).sum()), int(((cl > 0) & (cr > 0)).sum()), d

    m1, g1, d1 = counts(SEED)
    m2, g2, d2 = counts(SEED + 1)
    assert (m1, g1) == (m2, g2)
    assert not torch.equal(d1["left"]["k"], d2["left"]["k"])


def test_tpch_spec_derivations():
    d = tpch.generate(TPCH, SEED, "cpu")
    o, li, c, s = d["orders"], d["lineitem"], d["customer"], d["supplier"]
    n_orders = int(1500000 * 0.002)
    ok = o["o_orderkey"].long()
    assert ok.numel() == n_orders and bool((ok[1:] > ok[:-1]).all())
    assert bool(((ok % 32) < 8).all()) and int(ok.min()) == 1  # sparse keys
    assert bool((o["o_custkey"] % 3 != 0).all())
    assert int(o["o_custkey"].max()) <= c["c_custkey"].numel()
    assert int(o["o_orderdate"].max()) <= tpch.ORDER_DATE_MAX
    # 1 to 7 lines per order, each order's lines together
    lines = torch.unique_consecutive(li["l_orderkey"], return_counts=True)[1]
    assert lines.numel() == n_orders
    assert int(lines.min()) >= 1 and int(lines.max()) <= 7
    odate = torch.repeat_interleave(o["o_orderdate"], lines)
    ship, receipt = li["l_shipdate"], li["l_receiptdate"]
    assert int((ship - odate).min()) >= 1 and int((ship - odate).max()) <= 121
    assert int((receipt - ship).min()) >= 1
    assert int((receipt - ship).max()) <= 30
    flag = li["l_returnflag"][0][:, 0]
    status = li["l_linestatus"][0][:, 0]
    late = receipt > tpch.CURRENT_DATE
    assert bool(((flag == ord("N")) == late).all())
    assert bool(((flag == ord("R")) | (flag == ord("A")) | late).all())
    assert bool(((status == ord("O")) == (ship > tpch.CURRENT_DATE)).all())
    q = li["l_quantity"]
    assert float(q.min()) >= 1 and float(q.max()) <= 50
    assert float(li["l_discount"].max()) <= 0.1 + 1e-6
    assert float(li["l_tax"].max()) <= 0.08 + 1e-6
    assert int(li["l_suppkey"].min()) >= 1
    assert int(li["l_suppkey"].max()) <= s["s_suppkey"].numel()
    # Q1 sees the spec's four (returnflag, linestatus) groups
    groups = {(chr(a), chr(b)) for a, b in zip(flag.tolist(),
                                                status.tolist())}
    assert groups == {("A", "F"), ("R", "F"), ("N", "F"), ("N", "O")}
    assert tpch.day("1995-06-17") == tpch.CURRENT_DATE == 1263
    assert [n for n, r in zip(tpch.NATIONS, tpch.NATION_REGION) if r == 2] \
        == ["INDIA", "INDONESIA", "JAPAN", "CHINA", "VIETNAM"]


def text_of(col, i):
    data, lengths = col
    return bytes(data[i, :int(lengths[i])].tolist()).decode()


def test_tpch_every_column_at_the_spec_width():
    """All eight tables, every column of the schema, in its order: a
    string column as wide as its CHAR(n) or VARCHAR(n), zero past each
    length; the others int32 or float32."""
    d = tpch.generate(TPCH, SEED, "cpu")
    schema = TPCH["schema"]
    assert list(d) == list(schema) and len(schema) == 8
    assert sum(len(c) for c in schema.values()) == 61
    for t, cols in schema.items():
        assert list(d[t]) == list(cols)
        n = {len(v[0]) if isinstance(v, tuple) else len(v)
             for v in d[t].values()}
        assert len(n) == 1, t
        for c, sql in cols.items():
            v = d[t][c]
            w = tpch.width(sql)
            if w is None:
                want = torch.float32 if sql == "DECIMAL" else torch.int32
                assert v.dtype == want, c
                continue
            data, lengths = v
            assert data.dtype == torch.uint8 and data.shape[1] == w, c
            assert lengths.dtype == torch.int32
            assert int(lengths.min()) >= 1 and int(lengths.max()) <= w, c
            past = torch.arange(w)[None, :] >= lengths[:, None].long()
            assert int(data[past].max()) == 0 if past.any() else True, c
            assert int(data[~past].min()) >= 32, c
    for c, (lo, hi) in tpch.COMMENT.items():
        t = next(t for t, cols in schema.items() if c in cols)
        lengths = d[t][c][1]
        assert int(lengths.min()) >= lo and int(lengths.max()) <= hi, c


def test_tpch_other_columns_follow_the_spec():
    d = tpch.generate(TPCH, SEED, "cpu")
    p, s, ps = d["part"], d["supplier"], d["partsupp"]
    c, o, li = d["customer"], d["orders"], d["lineitem"]
    n_part, n_supp = p["p_partkey"].numel(), s["s_suppkey"].numel()
    # partsupp: four suppliers a part, by the formula l_suppkey uses
    assert ps["ps_partkey"].numel() == 4 * n_part
    k = torch.arange(4).repeat(n_part)
    part = ps["ps_partkey"].long()
    assert torch.equal(part, torch.arange(1, n_part + 1).repeat_interleave(4))
    assert torch.equal(ps["ps_suppkey"].long(), (
        part + k * (n_supp // 4 + (part - 1) // n_supp)) % n_supp + 1)
    pairs = set(zip(ps["ps_partkey"].tolist(), ps["ps_suppkey"].tolist()))
    assert set(zip(li["l_partkey"].tolist(),
                   li["l_suppkey"].tolist())) <= pairs
    # the price is the quantity times the part's retail price
    retail = p["p_retailprice"].double()[li["l_partkey"].long() - 1]
    assert torch.allclose(li["l_extendedprice"].double(),
                          li["l_quantity"].double() * retail, rtol=1e-6)
    # line numbers 1.. within each order, commit dates 30..90 days on
    lines = torch.unique_consecutive(li["l_orderkey"], return_counts=True)[1]
    start = torch.cumsum(lines, 0) - lines
    first = li["l_linenumber"][start]
    assert bool((first == 1).all())
    assert bool((li["l_linenumber"][start + lines - 1] == lines).all())
    odate = torch.repeat_interleave(o["o_orderdate"], lines)
    gap = li["l_commitdate"] - odate
    assert int(gap.min()) >= 30 and int(gap.max()) <= 90
    # order status from its lines, total price from its lines
    status = li["l_linestatus"][0][:, 0]
    order_of = torch.repeat_interleave(torch.arange(lines.numel()), lines)
    n_open = torch.zeros(lines.numel(), dtype=torch.long).index_add_(
        0, order_of, (status == ord("O")).long())
    want = torch.where(n_open == 0, ord("F"),
                       torch.where(n_open == lines, ord("O"), ord("P")))
    assert torch.equal(o["o_orderstatus"][0][:, 0].long(), want)
    term = (li["l_extendedprice"].double() * (1 + li["l_tax"].double())
            * (1 - li["l_discount"].double()))
    total = torch.zeros(lines.numel(), dtype=torch.float64).index_add_(
        0, order_of, term)
    assert torch.allclose(o["o_totalprice"].double(), total, rtol=1e-5)
    # formats
    assert text_of(c["c_name"], 0) == "Customer#000000001"
    assert text_of(s["s_name"], 1) == "Supplier#000000002"
    assert text_of(o["o_clerk"], 0).startswith("Clerk#")
    phone = text_of(c["c_phone"], 3)
    assert len(phone) == 15 and phone[2] + phone[6] + phone[10] == "---"
    assert int(phone[:2]) == int(c["c_nationkey"][3]) + 10
    for i in range(20):
        words = text_of(p["p_name"], i).split(" ")
        assert len(set(words)) == 5 and set(words) <= set(tpch.P_NAME_WORDS)
        m = text_of(p["p_mfgr"], i)
        assert m[:-1] == "Manufacturer#"
        assert text_of(p["p_brand"], i)[:7] == "Brand#" + m[-1]
        assert text_of(p["p_type"], i) in tpch.TYPES
        assert text_of(p["p_container"], i) in tpch.CONTAINERS
        assert text_of(c["c_mktsegment"], i) in tpch.SEGMENTS
        assert text_of(o["o_orderpriority"], i) in tpch.PRIORITIES
        assert text_of(li["l_shipinstruct"], i) in tpch.INSTRUCTIONS
        assert text_of(li["l_shipmode"], i) in tpch.MODES
    assert len(tpch.P_NAME_WORDS) == 92 and len(tpch.TYPES) == 150
    assert len(tpch.CONTAINERS) == 40
