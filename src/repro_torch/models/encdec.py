"""Whisper-style encoder-decoder backbone (counterpart of the JAX package's
``models/encdec.py``).

The mel-spectrogram and conv front end is a stub, as in the reference: the
batch carries precomputed frame embeddings (B, frames, d_model).  This
module is the transformer encoder (bidirectional) and decoder (causal
self-attention, cross-attention to the encoder's output, learned
positions, the embedding tied to the unembedding).

Two quirks of the reference are kept: the encoder's and the decoder's
self-attention apply RoPE (they share ``_gqa_qkv`` with the decoder-only
stack), and neither reaches the flash kernel: ``sdpa_auto`` is called
without ``use_pallas`` even when ``forward(use_pallas=True)``.

Decode keeps a self-attention cache whose ``kpos`` is shared by the batch
(every sequence at one depth) and cross K/V computed once from the
encoder's output (``prefill_cross``), so Whisper serves batch-synchronously;
``decode_step`` refuses a per-slot ``active`` mask.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import (_next_token_ce, checkpointed,
                                           layer)


def init(seed: int, cfg: ModelConfig, dtype=torch.float32, device=None
         ) -> Dict:
    """Parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless given; ``"meta"``: shapes only), with the
    reference's key paths; the encoder's and the decoder's layers are
    stacked (``enc``, ``dec``)."""
    device = resolve_device(device)
    gen = None if device.type == "meta" \
        else torch.Generator(device=device).manual_seed(seed)
    d, d_ff = cfg.d_model, cfg.d_ff

    def ln(lead):
        return L.layernorm_init(d, dtype, device, lead)

    def enc_block(n):
        lead = (n,)
        return {"ln1": ln(lead),
                "attn": A.gqa_init(gen, cfg, dtype, device, lead),
                "ln2": ln(lead),
                "mlp": L.gelu_mlp_init(gen, d, d_ff, dtype, device, lead)}

    def dec_block(n):
        lead = (n,)
        return {"ln1": ln(lead),
                "attn": A.gqa_init(gen, cfg, dtype, device, lead),
                "ln_x": ln(lead),
                "xattn": A.cross_attn_init(gen, cfg, dtype, device, lead),
                "ln2": ln(lead),
                "mlp": L.gelu_mlp_init(gen, d, d_ff, dtype, device, lead)}
    return {"embed": L.embedding_init(gen, cfg.vocab_size, d, dtype, device),
            "pos_dec": L.normal(gen, (cfg.max_seq_len, d), 0.01, dtype,
                                device),
            "enc": enc_block(cfg.n_encoder_layers),
            "enc_norm": ln(()),
            "dec": dec_block(cfg.n_layers),
            "dec_norm": ln(())}


def _self_attn(lp, hn, cfg, causal):
    B, Lq, _ = hn.shape
    positions = torch.arange(Lq, device=hn.device)[None, :]
    q, k, v = A._gqa_qkv(lp["attn"], hn, cfg, positions)
    out = A.sdpa_auto(q, k, v, causal=causal)
    return L.linear(lp["attn"]["wo"], out.reshape(B, Lq, -1))


def encode(params, frames, cfg: ModelConfig):
    """frames (B, F, d_model), the stub front end's output -> (B, F,
    d_model)."""
    x = frames
    for i in range(cfg.n_encoder_layers):
        lp = layer(params["enc"], i)
        x = x + _self_attn(lp, L.layernorm(lp["ln1"], x, cfg.norm_eps), cfg,
                           causal=False)
        x = x + L.gelu_mlp(lp["mlp"], L.layernorm(lp["ln2"], x, cfg.norm_eps))
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


def _unembed(params, x):
    return x @ params["embed"]["emb"].T.to(x.dtype)          # tied


def _dec_block(lp, x, enc_out, cfg):
    x = x + _self_attn(lp, L.layernorm(lp["ln1"], x, cfg.norm_eps), cfg,
                       causal=True)
    x = x + A.cross_attn(lp["xattn"], L.layernorm(lp["ln_x"], x, cfg.norm_eps),
                         enc_out, cfg)
    return x + L.gelu_mlp(lp["mlp"], L.layernorm(lp["ln2"], x, cfg.norm_eps))


def forward(params, batch, cfg: ModelConfig, use_pallas: bool = False,
            remat: str = "none", logits_slice: str = "all"):
    """batch: frames (B, F, d), tokens (B, L) -> (logits (B, L, V), aux 0).
    ``use_pallas`` is taken and ignored, as in the reference; ``remat``
    other than ``"none"`` recomputes each decoder block in the backward
    pass (the encoder is kept, as the reference keeps it)."""
    enc_out = encode(params, batch["frames"], cfg)
    x = L.embed(params["embed"], batch["tokens"])
    x = x + params["pos_dec"][: x.shape[1]].to(x.dtype)
    dec_block = checkpointed(_dec_block, remat)
    for i in range(cfg.n_layers):
        x = dec_block(layer(params["dec"], i), x, enc_out, cfg)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:]
    return _unembed(params, x), torch.zeros((), device=x.device)


def loss_fn(params, batch, cfg: ModelConfig, use_pallas: bool = False,
            remat: str = "none"):
    """Next-token cross-entropy; positions with label < 0 are masked.
    -> (ce, {"ce", "aux"}): the aux loss is 0 and not added."""
    logits, aux = forward(params, batch, cfg, use_pallas, remat)
    _, parts = _next_token_ce(logits, batch["labels"], aux)
    return parts["ce"], parts


# ---------------------------------------------------------------------------
# Decode: a self-attention cache and precomputed cross K/V.
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Self-attention K/V (n_layers, batch, min(max_len, max_seq_len), Hk,
    D) with one ``kpos`` (n_layers, S) shared by the batch, and cross K/V
    over ``max_len`` encoder frames (``prefill_cross`` replaces them)."""
    device = resolve_device(device)
    hd, nl = cfg.resolved_head_dim, cfg.n_layers
    dec_len = min(max_len, cfg.max_seq_len)

    def zeros(n):
        return torch.zeros((nl, batch, n, cfg.n_kv_heads, hd), dtype=dtype,
                           device=device)
    return {"k": zeros(dec_len), "v": zeros(dec_len),
            "kpos": torch.full((nl, dec_len), -1, dtype=torch.int32,
                               device=device),
            "xk": zeros(max_len), "xv": zeros(max_len)}


def prefill_cross(params, enc_out, cfg, cache):
    """The cross K/V of every decoder layer from the encoder's output ->
    a new cache."""
    B, Fr, _ = enc_out.shape
    shape = (B, Fr, cfg.n_kv_heads, cfg.resolved_head_dim)
    xa = params["dec"]["xattn"]
    xk = torch.stack([L.linear(layer(xa["wk"], i), enc_out).reshape(shape)
                      for i in range(cfg.n_layers)])
    xv = torch.stack([L.linear(layer(xa["wv"], i), enc_out).reshape(shape)
                      for i in range(cfg.n_layers)])
    return dict(cache, xk=xk.to(cache["xk"].dtype),
                xv=xv.to(cache["xv"].dtype))


def decode_step(params, cache, tokens, cur_pos, cfg: ModelConfig,
                active=None):
    """tokens (B, 1); cur_pos one int for the whole batch -> (logits (B,
    V), new cache).  The decoder's ``kpos`` is shared by the batch, so a
    per-slot ``active`` mask cannot be honoured (kpos would advance for
    masked rows) and is refused: Whisper serves batch-synchronously."""
    if active is not None:
        raise NotImplementedError(
            "enc-dec decode has a batch-shared kpos; per-slot active "
            "masking is unsupported — serve whisper batch-synchronously")
    B = tokens.shape[0]
    hd = cfg.resolved_head_dim
    pos = int(cur_pos)
    x = L.embed(params["embed"], tokens)
    x = x + params["pos_dec"][min(pos, cfg.max_seq_len - 1)].to(x.dtype)
    positions = torch.full((B, 1), pos, device=x.device)
    nk, nv, nkpos = [], [], []
    for i in range(cfg.n_layers):
        lp = layer(params["dec"], i)
        hn = L.layernorm(lp["ln1"], x, cfg.norm_eps)
        q, k, v = A._gqa_qkv(lp["attn"], hn, cfg, positions)
        ck, cv, ckpos = cache["k"][i], cache["v"][i], cache["kpos"][i]
        slot = pos % ck.shape[1]
        ck, cv, ckpos = ck.clone(), cv.clone(), ckpos.clone()
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        ckpos[slot] = pos
        valid = (ckpos >= 0) & (ckpos <= pos)
        out = A._sdpa(q, ck, cv, valid[None, None, None, :])
        x = x + L.linear(lp["attn"]["wo"], out.reshape(B, 1, -1))
        # cross-attention against the precomputed K/V
        hx = L.layernorm(lp["ln_x"], x, cfg.norm_eps)
        qx = L.linear(lp["xattn"]["wq"], hx).reshape(B, 1, cfg.n_heads, hd)
        outx = A._sdpa(qx, cache["xk"][i], cache["xv"][i], None)
        x = x + L.linear(lp["xattn"]["wo"], outx.reshape(B, 1, -1))
        x = x + L.gelu_mlp(lp["mlp"], L.layernorm(lp["ln2"], x, cfg.norm_eps))
        nk.append(ck)
        nv.append(cv)
        nkpos.append(ckpos)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return _unembed(params, x)[:, 0], dict(
        cache, k=torch.stack(nk), v=torch.stack(nv), kpos=torch.stack(nkpos))
