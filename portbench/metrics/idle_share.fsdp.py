"""``idle_share.train``'s reading in the fsdp cell, where it moves
``train_samples_per_s.fsdp``."""

from portbench import harness

read = harness.load_module("metrics", "idle_share.train").read
