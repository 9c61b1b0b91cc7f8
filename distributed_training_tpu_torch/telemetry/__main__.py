"""CLI entry: ``python -m distributed_training_tpu_torch.telemetry <run_dir>``."""

import os
import sys

from distributed_training_tpu_torch.telemetry.summarize import main

if __name__ == "__main__":
    try:
        rc = main()
    except BrokenPipeError:
        # Piped into head/less that quit early — not an error. Point
        # stdout at devnull so the interpreter's exit flush doesn't
        # raise a second time.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        rc = 0
    sys.exit(rc)
