"""The harness's general code: cells, scenes, traffic, timing, traces and
the comparison that decides `correct`."""
