import sys

from distributed_training_tpu_torch.launch.local import main

if __name__ == "__main__":
    sys.exit(main())
