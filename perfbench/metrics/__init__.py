"""One reader per per-layer metric, ``<metric>.py`` with ``read(records)``
returning the number, or None when the traced run holds nothing to read,
and ``example()``: a record built from ``_example.py``'s base and the
reading ``read`` must give on it, which the readers' test checks.

``records`` holds ``regions`` (the harness's host regions: label →
[(start, end)] in ``perf_counter`` seconds), ``trace`` (the device
events aligned to that clock, with the traced window ``t0``, ``t1``),
``busy_s`` and ``window_s``, ``config``, and what the cell's driver
recorded: for training ``rounds``, ``spans`` (the program's own trace
spans), ``flops``, ``agg_bytes`` and ``codec_bytes``.
"""
