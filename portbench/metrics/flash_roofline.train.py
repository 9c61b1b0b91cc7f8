"""The flash kernels' share of their roofline, in %: the sum over the
traced launches of B1 (forward), B2 (fused backward), B3a (dq) and B3b
(dk/dv) of each launch's bound (``yardstick/bounds.py``, at the step's
shapes) over the sum of their device times."""

import re

from portbench.yardstick import bounds

# The card's flash kernels (csrc/) by name. The backward kernel that
# takes dk/dv (B3b) and the fused backward (B2) are one template, told
# apart by its last argument: whether it also works out dq.
_FWD = ("flash_fwd_sm90_kernel", "flash_fwd_kernel")
_DQ = ("flash_bwd_dq_sm90_kernel", "flash_bwd_dq_kernel")
_DKV = ("flash_bwd_sm90_kernel", "flash_bwd_dkv_kernel")
_NAME = re.compile(r"\b(flash_\w+_kernel)<([^>]*)>")


def _part(name: str):
    """``fwd``, ``dq``, ``dkv`` or ``fused`` for a demangled launch name
    (``void flash_bwd_sm90_kernel<64, __nv_bfloat16, true>(...)``)."""
    m = _NAME.search(name)
    if m is None:
        return None
    kernel, last = m.group(1), m.group(2).split(",")[-1].strip()
    if kernel in _FWD:
        return "fwd"
    if kernel in _DQ:
        return "dq"
    if kernel in _DKV:
        return "fused" if last in ("true", "(bool)1") else "dkv"
    return None


def read(ctx):
    cfg, tr = ctx["cfg"], ctx["traffic"]
    B, S = tr["batch_per_chip"], tr["seq_len"]
    H = cfg["n_heads"]
    D = cfg["d_model"] // H
    Hkv = cfg.get("n_kv_heads") or H
    each = {"fwd": bounds.flash_fwd(B, H, S, D, Hkv=Hkv)}
    for part in ("fused", "dq", "dkv"):
        each[part] = bounds.flash_bwd(B, H, S, D, Hkv=Hkv, part=part)
    bound = spent = 0.0
    for ev in ctx["traced"]["device"]:
        part = _part(ev.name)
        if part is not None:
            bound += each[part]
            spent += ev.dur_ps * 1e-12
    return 100.0 * bound / spent if spent else None
