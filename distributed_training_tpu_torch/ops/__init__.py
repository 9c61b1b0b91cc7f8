"""Attention ops: the naive reference, the flash forward and backward,
and paged decode."""

# The kernel wrappers, each counting its launches: name → (module, attr).
WRAPPERS = {
    "flash_fwd": ("flash_attention", "flash_fwd"),
    "flash_bwd_fused": ("flash_attention", "flash_bwd_fused"),
    "flash_bwd_dq": ("flash_attention", "flash_bwd_dq"),
    "flash_bwd_dkv": ("flash_attention", "flash_bwd_dkv"),
    "paged_decode": ("paged_attention", "paged_attention"),
}


def kernel_launches(names=tuple(WRAPPERS)) -> dict:
    """Launches so far, in this process, of the named kernels, in all and
    by design. Each wrapper counts where it launches its kernel, so a
    process on the CPU reads zeros."""
    import importlib

    out = {}
    for name in names:
        module, attr = WRAPPERS[name]
        fn = getattr(importlib.import_module(
            f"distributed_training_tpu_torch.ops.{module}"), attr)
        out[name] = {"launches": fn.launches,
                     "by_design": dict(fn.launches_by_design)}
    return out
