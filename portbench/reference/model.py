"""The plain decoder the benchmark holds the program against.

Pre-norm blocks: layer norm (eps 1e-5), causal multi-head attention
with a 1/sqrt(head size) scale, learned positions (GPT-2) or rotary
positions over the whole head (half-split rotation, base 10000), a
residual after attention and another after the MLP (GELU, tanh form),
a final norm and the head (the embedding, transposed, when tied). Plain
``torch`` operations in float32, no kernel, no cache, no batching
beyond the rows it is given; ``matmul`` may be swapped for the fp8 one
of ``lowp.py`` (the control). Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import lowp


def _layer_norm(x, scale, bias):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-5) * scale + bias


def _rope(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Rotary positions on (B, H, S, hd), half-split, base 10000."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (10000 ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[:, None].float() * freqs[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Reference:
    """The decoder of a configuration (``cfg``: the run sizes) over a
    nested f32 weight dict; ``low`` swaps every matmul for fp8."""

    def __init__(self, cfg: dict, low: bool = False):
        self.cfg = cfg
        self.mm = lowp.matmul if low else torch.matmul

    def hidden(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> final-norm hidden states (B, S, D)."""
        c, mm = self.cfg, self.mm
        B, S = tokens.shape
        D, H = c["d_model"], c["n_heads"]
        Hkv = c.get("n_kv_heads") or H
        hd = D // H
        x = p["tok_embed"][tokens]
        if c["pos_encoding"] == "learned":
            x = x + p["pos_embed"][:S]
        positions = torch.arange(S, device=tokens.device)
        causal = torch.ones(S, S, dtype=torch.bool,
                            device=tokens.device).tril()
        for i in range(c["n_layers"]):
            a, m = ({k: w[i] for k, w in p[g].items()}
                    for g in ("attn", "mlp"))
            h = _layer_norm(x, p["ln1"]["scale"][i], p["ln1"]["bias"][i])
            q = mm(h, a["wq"].reshape(D, H * hd)).view(B, S, H, hd)
            k = mm(h, a["wk"].reshape(D, Hkv * hd)).view(B, S, Hkv, hd)
            v = mm(h, a["wv"].reshape(D, Hkv * hd)).view(B, S, Hkv, hd)
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            if Hkv != H:
                k = k.repeat_interleave(H // Hkv, dim=1)
                v = v.repeat_interleave(H // Hkv, dim=1)
            if c["pos_encoding"] == "rope":
                q, k = _rope(q, positions), _rope(k, positions)
            s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
            s = s.masked_fill(~causal, float("-inf"))
            o = mm(torch.softmax(s, dim=-1), v)
            o = o.transpose(1, 2).reshape(B, S, H * hd)
            x = x + mm(o, a["wo"].reshape(H * hd, D))
            h = _layer_norm(x, p["ln2"]["scale"][i], p["ln2"]["bias"][i])
            u = F.gelu(mm(h, m["wi"]) + m["bi"], approximate="tanh")
            x = x + mm(u, m["wo"]) + m["bo"]
        return _layer_norm(x, p["final_norm"]["scale"],
                           p["final_norm"]["bias"])

    def head(self, p: dict) -> torch.Tensor:
        return p["tok_embed"].T if self.cfg["tie_embeddings"] else p["lm_head"]

    def logits(self, p: dict, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> f32 logits (B, S, vocab rows)."""
        return self.mm(self.hidden(p, tokens), self.head(p))

    def nll_sum(self, p: dict, rows: torch.Tensor) -> torch.Tensor:
        """Summed next-token loss of rows (B, S + 1): the model reads
        ``rows[:, :-1]`` and predicts ``rows[:, 1:]``."""
        logits = self.logits(p, rows[:, :-1])
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               rows[:, 1:].reshape(-1), reduction="sum")
