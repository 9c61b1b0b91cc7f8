"""Paged decode's share of its roofline, in %: the bound of the decode
rows traced (``yardstick/bounds.py``; each row a token at its cached
length, in every layer) over the device time of B4's kernels (the split
pass and the combine) in the trace."""

from portbench.yardstick import bounds


def read(ctx):
    cfg, eng = ctx["cfg"], ctx["engine"]
    spent = sum(ev.dur_ps for ev in ctx["traced"]["device"]
                if ev.name.startswith("paged_")
                or "paged_split_kv" in ev.name
                or "paged_combine" in ev.name) * 1e-12
    rows = ctx["decode_rows"]
    if not spent or not rows:
        return None
    H = cfg["n_heads"]
    Hkv = cfg.get("n_kv_heads") or H
    hd = cfg["d_model"] // H
    bound = cfg["n_layers"] * sum(
        bounds.paged_decode([n], H, Hkv, hd, eng["page_size"])
        for n in rows)
    return 100.0 * bound / spent
