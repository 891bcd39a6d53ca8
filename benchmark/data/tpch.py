"""TPC-H's eight tables on the card from a seed, every column of each at
the width the configuration's ``schema`` gives it.

Follows the TPC-H specification, clause 4.2.3 (``assumed`` in the
configuration lists what departs from it):

- ``o_orderkey`` sparse as dbgen makes it: the first 8 keys of every 32;
- ``o_custkey`` uniform over the customers whose key is not a multiple of
  3 (a third of the customers place no order);
- ``o_orderdate`` uniform in [1992-01-01, 1998-12-31 minus 151 days];
- 1 to 7 lines per order, ``l_linenumber`` 1.. within the order;
  ``l_partkey`` uniform, ``l_suppkey`` one of the part's 4 suppliers by
  the spec's formula, the same formula that makes partsupp's rows;
- ``l_quantity`` 1..50, ``l_extendedprice`` the quantity times the part's
  retail price, ``l_discount`` 0..0.10 and ``l_tax`` 0..0.08 in steps of
  0.01;
- ``l_shipdate`` the order date plus 1..121 days, ``l_commitdate`` plus
  30..90, ``l_receiptdate`` the ship date plus 1..30 days;
  ``l_returnflag`` 'R' or 'A' at random when the receipt date is on or
  before 1995-06-17, else 'N'; ``l_linestatus`` 'O' when the ship date is
  after 1995-06-17, else 'F'; ``o_orderstatus`` 'F' or 'O' where all of
  an order's lines are, else 'P'; ``o_totalprice`` the sum of its lines'
  price x (1 + tax) x (1 - discount);
- names, phones, brands, types, containers, segments, priorities, ship
  instructions and modes from the spec's formats and lists; addresses
  the spec's v-strings; comments of the spec's lengths;
- the nation and region tables as the spec lists them.

Dates are int32 day numbers from 1992-01-01, decimals float32 and keys
int32.  A string column is a ``(uint8[n, width] bytes, int32[n]
lengths)`` pair, zero past its length.  Everything is drawn on
``device`` with one ``torch.Generator`` seeded with ``seed``; the
columns Q1 and Q5 read are drawn first, in a fixed order, so that the
others do not move them.
"""
from __future__ import annotations

import datetime
import re

import torch

EPOCH = datetime.date(1992, 1, 1)


def day(iso: str) -> int:
    """The day number of an ISO date, counted from 1992-01-01."""
    return (datetime.date.fromisoformat(iso) - EPOCH).days


START_DATE = day("1992-01-01")
CURRENT_DATE = day("1995-06-17")
END_DATE = day("1998-12-31")
ORDER_DATE_MAX = END_DATE - 151

NATIONS = ("ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT", "ETHIOPIA",
           "FRANCE", "GERMANY", "INDIA", "INDONESIA", "IRAN", "IRAQ",
           "JAPAN", "JORDAN", "KENYA", "MOROCCO", "MOZAMBIQUE", "PERU",
           "CHINA", "ROMANIA", "SAUDI ARABIA", "VIETNAM", "RUSSIA",
           "UNITED KINGDOM", "UNITED STATES")
NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1)
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")

# clause 4.2.2.13's lists
P_NAME_WORDS = (
    "almond antique aquamarine azure beige bisque black blanched blue "
    "blush brown burlywood burnished chartreuse chiffon chocolate coral "
    "cornflower cornsilk cream cyan dark deep dim dodger drab firebrick "
    "floral forest frosted gainsboro ghost goldenrod green grey honeydew "
    "hot indian ivory khaki lace lavender lawn lemon light lime linen "
    "magenta maroon medium metallic midnight mint misty moccasin navajo "
    "navy olive orange orchid pale papaya peach peru pink plum powder "
    "puff purple red rose rosy royal saddle salmon sandy seashell sienna "
    "sky slate smoke snow spring steel tan thistle tomato turquoise "
    "violet wheat white yellow").split()
TYPES = tuple(f"{a} {b} {c}"
              for a in ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY",
                        "PROMO")
              for b in ("ANODIZED", "BURNISHED", "PLATED", "POLISHED",
                        "BRUSHED")
              for c in ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
CONTAINERS = tuple(f"{a} {b}" for a in ("SM", "LG", "MED", "JUMBO", "WRAP")
                   for b in ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK",
                             "CAN", "DRUM"))
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD")
PRIORITIES = ("1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW")
INSTRUCTIONS = ("DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN")
MODES = ("REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB")
# clause 4.2.2.7's v-string alphabet, and the letters and spaces of the
# comments
VSTRING = (b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
           b"0123456789, ")
TEXT = b"abcdefghijklmnopqrstuvwxyz     "
# comment lengths, clause 4.2.3: text strings of [lo, hi] characters
COMMENT = {"p_comment": (5, 22), "s_comment": (25, 100),
           "ps_comment": (49, 198), "c_comment": (29, 116),
           "o_comment": (19, 78), "l_comment": (10, 43),
           "n_comment": (31, 114), "r_comment": (31, 115)}
ADDRESS = (10, 40)
CHUNK = 1 << 27  # bytes of a string column drawn per call

_WIDTH = re.compile(r"^(?:VAR)?CHAR\((\d+)\)$")


def width(sql_type: str) -> int | None:
    """The width of a CHAR(n) or VARCHAR(n) type; None for the others."""
    m = _WIDTH.match(sql_type)
    return int(m.group(1)) if m else None


def strings(values, width: int, device):
    """A string column of ``values``: (bytes, lengths) on ``device``."""
    mat = torch.zeros((len(values), width), dtype=torch.uint8)
    for i, v in enumerate(values):
        b = v.encode()
        if len(b) > width:
            raise ValueError(f"{v!r} is wider than {width}")
        mat[i, :len(b)] = torch.tensor(list(b), dtype=torch.uint8)
    lens = torch.tensor([len(v) for v in values], dtype=torch.int32)
    return mat.to(device), lens.to(device)


def pick(values, codes: torch.Tensor, width: int):
    """The ``codes``-th strings of ``values``, as a string column."""
    mat, lens = strings(values, width, codes.device)
    return mat[codes.long()], lens[codes.long()]


def char1(codes: torch.Tensor, alphabet: bytes):
    """A CHAR(1) column: the ``codes``-th letters of ``alphabet``."""
    table = torch.tensor(list(alphabet), dtype=torch.uint8,
                         device=codes.device)
    mat = table[codes.long()].reshape(-1, 1)
    return mat, torch.ones(mat.shape[0], dtype=torch.int32,
                           device=codes.device)


def digits(values: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[len, n]: ``values`` in ``n`` decimal digits, zero-padded."""
    p = 10 ** torch.arange(n - 1, -1, -1, device=values.device)
    return ((values.long()[:, None] // p) % 10 + ord("0")).to(torch.uint8)


def concat(parts, width: int):
    """A string column of fixed-width pieces (uint8 matrices, or bytes
    repeated on every row) side by side."""
    rows = next(p.shape[0] for p in parts if isinstance(p, torch.Tensor))
    dev = next(p.device for p in parts if isinstance(p, torch.Tensor))
    mats = [p if isinstance(p, torch.Tensor) else
            torch.tensor(list(p), dtype=torch.uint8, device=dev).expand(
                rows, len(p)) for p in parts]
    body = torch.cat(mats, dim=1)
    if body.shape[1] > width:
        raise ValueError(f"{body.shape[1]} bytes do not fit in {width}")
    out = torch.zeros((rows, width), dtype=torch.uint8, device=dev)
    out[:, :body.shape[1]] = body
    return out, torch.full((rows,), body.shape[1], dtype=torch.int32,
                           device=dev)


def generate(config: dict, seed: int, device) -> dict:
    """{table name: {column name: tensor or (bytes, lengths)}} at
    ``config["scale_factor"]``, in the order and at the widths of
    ``config["schema"]``."""
    sf = config["scale_factor"]
    schema = config["schema"]
    n_orders = int(config["orders_per_sf"] * sf)
    n_cust = int(config["customers_per_sf"] * sf)
    n_supp = int(config["suppliers_per_sf"] * sf)
    n_part = int(config["parts_per_sf"] * sf)
    n_clerk = max(int(config["clerks_per_sf"] * sf), 1)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    i32, f32 = torch.int32, torch.float32

    def randint(lo: int, hi: int, n: int) -> torch.Tensor:
        """int64 uniform in [lo, hi]."""
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device)

    def cents(lo: int, hi: int, n: int) -> torch.Tensor:
        """float32 uniform in [lo, hi] hundredths."""
        return (randint(lo, hi, n).double() / 100).to(f32)

    def text(n: int, bounds, col: str, alphabet: bytes = TEXT):
        """Strings of ``bounds`` characters from ``alphabet``."""
        w = width(schema_of[col])
        table = torch.tensor(list(alphabet), dtype=torch.uint8,
                             device=device)
        lens = randint(*bounds, n).to(i32)
        out = torch.empty((n, w), dtype=torch.uint8, device=device)
        step = max(CHUNK // w, 1)
        cols = torch.arange(w, device=device)
        for a in range(0, n, step):
            b = min(a + step, n)
            codes = torch.randint(0, len(alphabet), (b - a, w), generator=g,
                                  device=device, dtype=i32)
            chunk = table[codes]
            chunk[cols >= lens[a:b, None]] = 0
            out[a:b] = chunk
        return out, lens

    def phone(nation: torch.Tensor):
        """Clause 4.2.2.9: country code (nation + 10), then 3, 3 and 4
        random digits."""
        n = nation.numel()
        return concat([digits(nation + 10, 2), b"-",
                       digits(randint(100, 999, n), 3), b"-",
                       digits(randint(100, 999, n), 3), b"-",
                       digits(randint(1000, 9999, n), 4)], 15)

    schema_of = {c: t for cols in schema.values() for c, t in cols.items()}

    # -- the columns Q1 and Q5 read, in their fixed order ------------------
    i = torch.arange(1, n_orders + 1, device=device)
    orderkey = ((i >> 3) << 5) | (i & 7)
    placing = n_cust - n_cust // 3  # customers whose key is not 0 mod 3
    j = randint(0, placing - 1, n_orders)
    custkey = 3 * (j // 2) + 1 + j % 2
    orderdate = randint(START_DATE, ORDER_DATE_MAX, n_orders)

    lines = randint(1, 7, n_orders)
    order_of_line = torch.repeat_interleave(
        torch.arange(n_orders, device=device), lines)
    n_lines = order_of_line.numel()
    partkey = randint(1, n_part, n_lines)
    supp_i = randint(0, 3, n_lines)

    def supplier_of(part: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        """The spec's k-th supplier (0..3) of ``part``."""
        return ((part + k * (n_supp // 4 + (part - 1) // n_supp)) % n_supp
                + 1)

    suppkey = supplier_of(partkey, supp_i)
    quantity = randint(1, 50, n_lines)

    def retail_cents(part: torch.Tensor) -> torch.Tensor:
        return 90000 + (part // 10) % 20001 + 100 * (part % 1000)

    price = (quantity * retail_cents(partkey)).double() / 100
    discount = randint(0, 10, n_lines).double() / 100
    tax = randint(0, 8, n_lines).double() / 100
    shipdate = orderdate[order_of_line] + randint(1, 121, n_lines)
    receiptdate = shipdate + randint(1, 30, n_lines)
    returned = receiptdate <= CURRENT_DATE
    flag = torch.where(returned, randint(0, 1, n_lines), 2)  # A R | N
    status = (shipdate > CURRENT_DATE).long()  # F | O
    c_nationkey = randint(0, 24, n_cust)
    s_nationkey = randint(0, 24, n_supp)

    # -- the other columns --------------------------------------------------
    first_line = torch.cumsum(lines, 0) - lines
    linenumber = (torch.arange(n_lines, device=device)
                  - first_line[order_of_line] + 1)
    commitdate = orderdate[order_of_line] + randint(30, 90, n_lines)
    line_total = torch.round(price * (1 + tax) * (1 - discount) * 100) / 100
    totalprice = torch.zeros(n_orders, dtype=torch.float64, device=device)
    totalprice.index_add_(0, order_of_line, line_total)
    open_lines = torch.zeros(n_orders, dtype=torch.int64, device=device)
    open_lines.index_add_(0, order_of_line, status)
    orderstatus = torch.where(open_lines == 0, 0,
                              torch.where(open_lines == lines, 1, 2))

    parts = torch.arange(1, n_part + 1, device=device)
    # five distinct words a name: the five largest of 92 uniform draws
    words = torch.rand((n_part, len(P_NAME_WORDS)), generator=g,
                       device=device).topk(5, dim=1).indices
    mfgr = randint(1, 5, n_part)
    brand = randint(1, 5, n_part)
    ps_part = parts.repeat_interleave(4)
    ps_supp = supplier_of(ps_part, torch.arange(4, device=device).repeat(
        n_part))

    def part_name(idx: torch.Tensor):
        """Five words of P_NAME_WORDS, one space between."""
        w = width(schema_of["p_name"])
        mat, lens = strings(P_NAME_WORDS, max(map(len, P_NAME_WORDS)),
                            device)
        wide = mat.shape[1]
        out = torch.zeros((idx.shape[0], w + wide), dtype=torch.uint8,
                          device=device)
        at = torch.zeros(idx.shape[0], dtype=torch.int64, device=device)
        span = torch.arange(wide, device=device)
        for k in range(idx.shape[1]):
            if k:
                out.scatter_(1, at[:, None], ord(" "))
                at = at + 1
            out.scatter_(1, at[:, None] + span, mat[idx[:, k]])
            at = at + lens[idx[:, k]]
        return out[:, :w].contiguous(), at.to(i32)

    cust = torch.arange(1, n_cust + 1, device=device)
    supp = torch.arange(1, n_supp + 1, device=device)
    tables = {
        "part": {
            "p_partkey": parts.to(i32),
            "p_name": part_name(words),
            "p_mfgr": concat([b"Manufacturer#", digits(mfgr, 1)],
                             width(schema_of["p_mfgr"])),
            "p_brand": concat([b"Brand#", digits(mfgr, 1), digits(brand, 1)],
                              width(schema_of["p_brand"])),
            "p_type": pick(TYPES, randint(0, len(TYPES) - 1, n_part),
                           width(schema_of["p_type"])),
            "p_size": randint(1, 50, n_part).to(i32),
            "p_container": pick(CONTAINERS,
                                randint(0, len(CONTAINERS) - 1, n_part),
                                width(schema_of["p_container"])),
            "p_retailprice": (retail_cents(parts).double() / 100).to(f32),
            "p_comment": text(n_part, COMMENT["p_comment"], "p_comment"),
        },
        "supplier": {
            "s_suppkey": supp.to(i32),
            "s_name": concat([b"Supplier#", digits(supp, 9)],
                             width(schema_of["s_name"])),
            "s_address": text(n_supp, ADDRESS, "s_address", VSTRING),
            "s_nationkey": s_nationkey.to(i32),
            "s_phone": phone(s_nationkey),
            "s_acctbal": cents(-99999, 999999, n_supp),
            "s_comment": text(n_supp, COMMENT["s_comment"], "s_comment"),
        },
        "partsupp": {
            "ps_partkey": ps_part.to(i32),
            "ps_suppkey": ps_supp.to(i32),
            "ps_availqty": randint(1, 9999, 4 * n_part).to(i32),
            "ps_supplycost": cents(100, 100000, 4 * n_part),
            "ps_comment": text(4 * n_part, COMMENT["ps_comment"],
                               "ps_comment"),
        },
        "customer": {
            "c_custkey": cust.to(i32),
            "c_name": concat([b"Customer#", digits(cust, 9)],
                             width(schema_of["c_name"])),
            "c_address": text(n_cust, ADDRESS, "c_address", VSTRING),
            "c_nationkey": c_nationkey.to(i32),
            "c_phone": phone(c_nationkey),
            "c_acctbal": cents(-99999, 999999, n_cust),
            "c_mktsegment": pick(SEGMENTS,
                                 randint(0, len(SEGMENTS) - 1, n_cust),
                                 width(schema_of["c_mktsegment"])),
            "c_comment": text(n_cust, COMMENT["c_comment"], "c_comment"),
        },
        "orders": {
            "o_orderkey": orderkey.to(i32),
            "o_custkey": custkey.to(i32),
            "o_orderstatus": char1(orderstatus, b"FOP"),
            "o_totalprice": totalprice.to(f32),
            "o_orderdate": orderdate.to(i32),
            "o_orderpriority": pick(PRIORITIES,
                                    randint(0, len(PRIORITIES) - 1,
                                            n_orders),
                                    width(schema_of["o_orderpriority"])),
            "o_clerk": concat([b"Clerk#", digits(randint(1, n_clerk,
                                                         n_orders), 9)],
                              width(schema_of["o_clerk"])),
            "o_shippriority": torch.zeros(n_orders, dtype=i32,
                                          device=device),
            "o_comment": text(n_orders, COMMENT["o_comment"], "o_comment"),
        },
        "lineitem": {
            "l_orderkey": orderkey[order_of_line].to(i32),
            "l_partkey": partkey.to(i32),
            "l_suppkey": suppkey.to(i32),
            "l_linenumber": linenumber.to(i32),
            "l_quantity": quantity.to(f32),
            "l_extendedprice": price.to(f32),
            "l_discount": discount.to(f32),
            "l_tax": tax.to(f32),
            "l_returnflag": char1(flag, b"ARN"),
            "l_linestatus": char1(status, b"FO"),
            "l_shipdate": shipdate.to(i32),
            "l_commitdate": commitdate.to(i32),
            "l_receiptdate": receiptdate.to(i32),
            "l_shipinstruct": pick(INSTRUCTIONS,
                                   randint(0, len(INSTRUCTIONS) - 1,
                                           n_lines),
                                   width(schema_of["l_shipinstruct"])),
            "l_shipmode": pick(MODES, randint(0, len(MODES) - 1, n_lines),
                               width(schema_of["l_shipmode"])),
            "l_comment": text(n_lines, COMMENT["l_comment"], "l_comment"),
        },
        "nation": {
            "n_nationkey": torch.arange(len(NATIONS), device=device,
                                        dtype=i32),
            "n_name": strings(NATIONS, width(schema_of["n_name"]), device),
            "n_regionkey": torch.tensor(NATION_REGION, device=device,
                                        dtype=i32),
            "n_comment": text(len(NATIONS), COMMENT["n_comment"],
                              "n_comment"),
        },
        "region": {
            "r_regionkey": torch.arange(len(REGIONS), device=device,
                                        dtype=i32),
            "r_name": strings(REGIONS, width(schema_of["r_name"]), device),
            "r_comment": text(len(REGIONS), COMMENT["r_comment"],
                              "r_comment"),
        },
    }
    return {t: {c: tables[t][c] for c in cols} for t, cols in schema.items()}
