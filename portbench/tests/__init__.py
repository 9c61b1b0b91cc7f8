"""Part of the portbench harness."""
