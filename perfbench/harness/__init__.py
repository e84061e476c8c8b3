"""The benchmark's machinery: finding a cell's files by name (``spec``),
the whole-request window (``window``), reading the profiler's trace
(``trace``) and running one cell once (``runner``)."""
