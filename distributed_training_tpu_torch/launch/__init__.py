"""Launch layer of the port: a local multi-process launcher (port of
``launch/``), the counterpart of ``torchrun``'s local mode and of the
reference playground's ``mp.spawn``."""

from distributed_training_tpu_torch.launch.local import (  # noqa: F401
    LocalProcess,
    launch_local,
    main,
)
