"""``device.hbm_roofline_share``'s bytes are a frozen formula of the
cell's configuration and mix: the route the program's plan picks does
not enter it, and the reader leaves the metric out for a card the table
of peaks lacks."""
from __future__ import annotations

import pytest

from dintbench import hbm, registry, sut
from dintbench.tests.tiny import with_later

CELLS = ["tatp-7m.closed-w128k", "smallbank-24m.closed-w64k",
         "tatp-7m-3srv.closed-w32k"]


@pytest.mark.parametrize("cell", CELLS)
def test_bytes_depend_on_the_configuration_and_mix_only(monkeypatch, cell):
    c = registry.cell(with_later(registry.load()), cell)
    before = hbm.step_bytes(c["cfg"], c["mix"])
    for route in ({}, {"use_hotset": True}, {"use_fused": True}):
        monkeypatch.setattr(sut, "_route", lambda wl, r=route: r)
        assert hbm.step_bytes(dict(c["cfg"]), dict(c["mix"])) == before
    assert before > 0


def test_tatp_bytes_by_hand():
    c = registry.cell(registry.load(), "tatp-7m.closed-w128k")
    cfg, mix = c["cfg"], c["mix"]
    p = cfg["mix"]
    reads = p[0] + p[1] + 2 * p[2] + 2 * p[3] + 2 * p[4] + 2 * p[5] + p[6]
    locks = 2 * p[3] + p[4] + p[5] + p[6]
    row = 1 + cfg["val_words"]
    entry = 4 + cfg["val_words"]
    per = 6 + reads * row + 2 * locks + locks * (row + 3 * entry)
    assert hbm.step_bytes(cfg, mix) == pytest.approx(
        4 * mix["width"] * per)


def test_three_servers_move_their_backups_too():
    one = registry.cell(registry.load(), "tatp-7m.closed-w128k")
    three = registry.cell(with_later(registry.load()),
                          "tatp-7m-3srv.closed-w32k")
    # per transaction: the same work plus two backup rows a write
    a = hbm.step_bytes(one["cfg"], one["mix"]) / one["mix"]["width"]
    b = hbm.step_bytes(three["cfg"], three["mix"]) / (
        3 * three["mix"]["width"])
    assert b > a


def test_unknown_card_reads_nothing():
    read = registry.reader("device.hbm_roofline_share")
    view = {"busy_s": 1.0, "steps": 10, "window_s": 2.0}
    ctx = {"step_bytes": 1e6, "peak_bytes_s": hbm.peak("a card not listed")}
    assert read([view], ctx) is None
    ctx["peak_bytes_s"] = hbm.peak("NVIDIA H100 80GB HBM3")
    assert 0 < read([view], ctx) < 100
