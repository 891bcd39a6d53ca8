"""A whole run with the timed path broken underneath reports ``correct``
false, once for each fault a cell of this benchmark can have: an answer
altered where it is produced, and half of the rows left out.  (A step
that returns its state unchanged and an exchange between chips left out
do not arise: a query keeps no state between calls, and every cell runs
on one chip.)"""
import time

import pytest
import torch

import cylon_tpu_torch.ops.groupby as groupby_mod
from benchmark import harness, portio
from cylon_tpu_torch import Table

from .conftest import SEED, TINY


def run(cell):
    return harness.run_cell(cell, SEED, 0.2, False, "cpu",
                            time.perf_counter(), TINY[cell])


def test_sound_runs_are_correct():
    for cell in TINY:
        assert run(cell)["correct"], cell


@pytest.mark.parametrize("cell", ["jg-sort-2p28", "jg-hash-2p28"])
def test_altered_group_sum(cell, monkeypatch):
    real = groupby_mod.pipeline_groupby

    def altered(*args, **kwargs):
        gcols, g = real(*args, **kwargs)
        gcols[1].data[0] *= 1.01
        return gcols, g

    monkeypatch.setattr(groupby_mod, "pipeline_groupby", altered)
    out = run(cell)
    assert not out["correct"]
    assert out["checks"]["sum_rel_gap"]["value"] > \
        out["checks"]["sum_rel_gap"]["limit"]


@pytest.mark.parametrize("cell,name", [("tpch-q1-sf10", "sum_l_quantity"),
                                       ("tpch-q5-sf10", "sum_revenue")])
def test_altered_tpch_answer(cell, name, monkeypatch):
    real = Table.to_numpy

    def altered(self):
        out = real(self)
        if name in out:
            out[name] = out[name].copy()
            out[name][0] *= 1.01
        return out

    monkeypatch.setattr(Table, "to_numpy", altered)
    assert not run(cell)["correct"]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_half_the_rows_left_out(cell, monkeypatch):
    """The program sees the first half of every input table's rows; the
    reference all of them."""
    real_table = portio.table

    def half_table(ctx, cols, names=None):
        t = real_table(ctx, cols, names)
        count = torch.tensor(t.shards[0][0].capacity // 2, dtype=torch.int32)
        return Table(t.shards, (count,), t.names, t.ctx)

    monkeypatch.setattr(portio, "table", half_table)
    if cell.startswith("jg"):
        from benchmark.queries import join_groupby as q
        real_prepare = q.prepare

        def half_prepare(inputs, params, device):
            st = real_prepare(inputs, params, device)
            cols_l, cnt_l, cols_r, cnt_r = st["tables"]
            st["tables"] = (cols_l, cnt_l // 2, cols_r, cnt_r)
            return st

        monkeypatch.setattr(q, "prepare", half_prepare)
    assert not run(cell)["correct"]
