"""Serving: paged KV cache, continuous-batching engine, HTTP server.

- ``kv_cache.py`` — the paged KV pool and its host-side allocator;
- ``engine.py``   — the continuous-batching engine (prefill + decode
  programs, speculative and device-resident decode, prefix sharing,
  sessions, live weight swap, drain, preempt, KV export and adoption,
  the fault hooks);
- ``disagg.py``   — int8 weight-only leaves and the KV handoff
  primitives;
- ``server.py``   — the stdlib HTTP generate endpoint and its swap and
  drain controls.
"""

from distributed_training_tpu_torch.serving.engine import (  # noqa: F401
    Engine,
    EngineConfig,
    Request,
)
from distributed_training_tpu_torch.serving.kv_cache import (  # noqa: F401
    PagedCacheConfig,
    PagedKVCache,
)
