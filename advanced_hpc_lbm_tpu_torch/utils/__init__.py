"""Runtime utilities: I/O codecs, validation checker, timers, checkpoints,
profiling, the ||u|| heatmap of a final state (``viz``)."""
