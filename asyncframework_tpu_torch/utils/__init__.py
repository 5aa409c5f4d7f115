"""Host utilities: clocks, flop accounting, device memory planning."""
