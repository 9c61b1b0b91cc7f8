"""The benchmark's frozen arithmetic: peaks, FLOP counts, kernel bounds
and the device-timeline reduction."""
