"""Host utilities: run statistics and timers."""
