import sys

from distributed_training_tpu_torch.train.cli import main

if __name__ == "__main__":
    sys.exit(main())
