"""Per-request token sampling for the batched decode step (counterpart of
the JAX package's ``serving/sampling.py``).

Each row carries its own (temperature, top_k, seed, counter); temperature
<= 0 selects greedy for that row, top_k <= 0 disables truncation.  The
Gumbel draws enter as an operand (``gumbel=``, (B, V) fp32), as the
wire's QSGD uniforms do: the reference draws them from JAX's threefry keyed
on ``fold_in(PRNGKey(seed), counter)``, which no torch generator
reproduces, so the parity tests pass the reference's own draws.  By
default a row's draws come from a ``torch.Generator`` on the logits'
device seeded from (seed, counter) alone, so a request samples the same
whether it runs alone or batched.
"""
from __future__ import annotations

import torch

_TINY = torch.finfo(torch.float32).tiny
_M64 = (1 << 64) - 1


def row_seed(seed: int, counter: int) -> int:
    """One generator seed from a request's seed and output position: the
    pair hashed by splitmix64's finaliser, so every bit of the seed moves
    the low 32 bits too (the CPU generator reads only those)."""
    x = ((int(seed) & 0xFFFFFFFF) << 32 | (int(counter) & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & 0x7FFFFFFFFFFFFFFF


def gumbel_noise(seeds, counters, vocab: int, device) -> torch.Tensor:
    """(B, vocab) fp32 standard Gumbel draws, row i from a generator seeded
    with ``row_seed(seeds[i], counters[i])``."""
    rows = []
    for s, c in zip(seeds, counters):
        gen = torch.Generator(device=device).manual_seed(row_seed(s, c))
        rows.append(torch.rand(vocab, generator=gen, device=device))
    u = torch.stack(rows).clamp_min(_TINY)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, temps, top_ks, seeds, counters, gumbel=None):
    """logits (B, V); temps (B,) fp32; top_ks (B,) ints; seeds and counters
    (B,) ints (sequences or tensors); gumbel (B, V) fp32 or None -> tokens
    (B,) int32.  Top-k keeps every logit tied at the k-th largest; argmax
    takes the first maximal index."""
    logits = logits.float()
    B, V = logits.shape
    dev = logits.device
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    top_ks = torch.as_tensor(top_ks, device=dev).long()
    greedy = torch.argmax(logits, dim=-1)
    if not bool((temps > 0).any()):
        return greedy.to(torch.int32)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = torch.clamp(top_ks - 1, 0, V - 1)
    thresh = torch.gather(sorted_desc, 1, k_idx[:, None])
    cut = (top_ks > 0)[:, None] & (logits < thresh)
    scaled = torch.where(cut, torch.full_like(logits, -torch.inf),
                         logits / torch.clamp_min(temps, 1e-6)[:, None])
    if gumbel is None:
        gumbel = gumbel_noise([int(s) for s in seeds],
                              [int(c) for c in counters], V, dev)
    sampled = torch.argmax(scaled + gumbel.to(dev), dim=-1)
    return torch.where(temps <= 0, greedy, sampled).to(torch.int32)
