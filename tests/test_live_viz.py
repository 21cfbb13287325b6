"""Timer-refresh semantics of the live plotting sinks (reference QTimer
behavior, lib/heatmap_plot.cc:130-206 / lib/time_plot.cc:101-141)."""
import numpy as np

from jrc.viz.live import LiveHeatmap, LiveTimePlot


def test_live_heatmap_coalesces_pushes(tmp_path):
    path = str(tmp_path / "hm.png")
    hm = LiveHeatmap(np.linspace(0, 40, 64), np.linspace(-60, 60, 32),
                     path=path, refresh_interval_s=1.0)
    rng = np.random.default_rng(0)
    # three data pushes inside one refresh interval -> exactly one draw
    for k in range(3):
        hm.push(rng.random((64, 32)))
        hm.tick(now=0.1 * k)
    assert (hm.n_pushed, hm.n_drawn) == (3, 1)
    import os
    assert os.path.exists(path)
    # the coalesced newest frame is drawn at the next interval
    assert hm.tick(now=2.0) is True
    # no new data since -> no redraw
    assert hm.tick(now=4.0) is False
    # new data in a new interval -> redraw
    hm.push(rng.random((64, 32)))
    assert hm.tick(now=5.5) is True
    assert hm.n_drawn == 3


def test_live_timeplot_sliding_window(tmp_path):
    path = str(tmp_path / "tp.png")
    tp = LiveTimePlot(window_s=10.0, path=path, refresh_interval_s=0.5)
    for t in range(15):
        tp.push("snr_db", float(t), 20.0 + t)
    assert tp.tick(now=100.0) is True
    # the window evicted everything older than t=14-10
    ts = [t for t, _ in tp.series._data["snr_db"]]
    assert min(ts) >= 4.0
    import os
    assert os.path.exists(path)
