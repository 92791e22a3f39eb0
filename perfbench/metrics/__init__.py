"""Per-layer metric readers, one file per metric in `BENCHMARK.json`
(``<name>.py`` with ``read(run)``); a metric split by suffix, such as
``agg_ms.train`` and ``agg_ms.infer``, shares the reader of its base
name (``agg_ms.py``).  Files starting with ``_`` hold their shared
arithmetic."""
