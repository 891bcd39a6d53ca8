"""TPC-H Q1 (pricing summary report) through the table API, eager: the
calls of ``cylon_tpu_torch.pipeline.tpch_q1``, with the ship-date cutoff
as TPC-H states it, 1998-12-01 minus 90 days (the validation value of
DELTA).  The program holds the whole lineitem table, every column; the
query first projects the seven columns Q1 reads, as an engine would, and
ends when the groups are on the host."""
from __future__ import annotations

from cylon_tpu_torch import CylonContext

from .. import portio
from ..data.tpch import day

TABLES = ("lineitem",)
COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate")
CUTOFF = day("1998-12-01") - 90
AGGS = {
    "l_quantity": ["sum", "mean"],
    "l_extendedprice": ["sum", "mean"],
    "disc_price": ["sum"],
    "charge": ["sum"],
    "l_discount": ["mean", "count"],
}


def prepare(inputs: dict, params: dict, device):
    return portio.table(CylonContext.Init(device), inputs["lineitem"])


def run(t):
    f = t.project(list(COLUMNS)).select(lambda r: r.l_shipdate <= CUTOFF)
    f["disc_price"] = (f["l_extendedprice"] * (f["l_discount"] * -1.0 + 1.0))
    f["charge"] = f["disc_price"] * (f["l_tax"] + 1.0)
    return f.groupby(["l_returnflag", "l_linestatus"], AGGS).to_numpy()


def keep(result):
    """The result is already a small frame on the host."""
    return result


def answer(result) -> dict:
    """{(returnflag, linestatus): {aggregate: value}}."""
    names = [n for n in result if n not in ("l_returnflag", "l_linestatus")]
    return {(str(rf), str(ls)): {n: float(result[n][i]) for n in names}
            for i, (rf, ls) in enumerate(zip(result["l_returnflag"],
                                             result["l_linestatus"]))}
