"""Runtime utilities: I/O codecs, validation checker, timers, checkpoints,
profiling."""
