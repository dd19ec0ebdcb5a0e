"""Analytic parameter and FLOP counts per (arch x shape).

The closed-form counts of ``repro.models.counting``, in pure Python: the
model-FLOP and roofline inputs of every (arch x shape) cell, and the
FLOP bound of an LM prefill on the card (``chip_smoke.py``, phase ``lm``).

Conventions: 1 MAC = 2 FLOPs; causal attention scores/PV counted at the
full rectangle / 2; backward = 2x forward matmul FLOPs; full remat adds
+1x forward.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.config import (ATTN_FULL, ATTN_MLA, ATTN_SLIDING,
                                FFN_MOE, MAMBA, RWKV6, ArchConfig,
                                ShapeConfig)

__all__ = ["count_params", "step_flops"]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def _mixer_params(cfg: ArchConfig, kind: str) -> int:
    d = cfg.d_model
    if kind in (ATTN_FULL, ATTN_SLIDING):
        a = cfg.attn
        p = d * a.num_q_heads * a.head_dim * 2          # wq, wo
        p += d * a.num_kv_heads * a.head_dim * 2        # wk, wv
        if a.qkv_bias:
            p += (a.num_q_heads + 2 * a.num_kv_heads) * a.head_dim
        return p
    if kind == ATTN_MLA:
        a = cfg.attn
        return (d * a.q_lora_rank + a.q_lora_rank
                + a.q_lora_rank * a.num_q_heads * (a.qk_nope_dim + a.qk_rope_dim)
                + d * (a.kv_lora_rank + a.qk_rope_dim) + a.kv_lora_rank
                + a.kv_lora_rank * a.num_q_heads * (a.qk_nope_dim + a.v_head_dim)
                + a.num_q_heads * a.v_head_dim * d)
    if kind == MAMBA:
        m = cfg.mamba
        di = m.expand * d
        dtr = math.ceil(d / 16)
        return (d * 2 * di + m.d_conv * di + di
                + di * (dtr + 2 * m.d_state) + dtr * di + di
                + di * m.d_state + di + di * d)
    if kind == RWKV6:
        lora = 64
        return 5 * d + d + d * lora + lora * d + 4 * d * d + d + d + d * d
    raise ValueError(kind)


def _ffn_params(cfg: ArchConfig, kind: str, active_only: bool = False) -> int:
    d = cfg.d_model
    if kind == FFN_MOE:
        m = cfg.moe
        routed = m.top_k if active_only else m.num_experts
        p = d * m.num_experts                            # router
        p += routed * 3 * d * m.d_expert
        p += m.num_shared * 3 * d * m.d_expert
        return p
    if cfg.rwkv is not None:
        return d + 2 * d * cfg.d_ff
    return 3 * d * cfg.d_ff


def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    total = 0
    for mk, fk in cfg.pattern():
        total += _mixer_params(cfg, mk) + _ffn_params(cfg, fk, active_only)
        total += 2 * cfg.d_model                         # two RMS norms
    total += cfg.d_model                                 # final norm
    if cfg.frontend in ("tokens", "patches+tokens"):
        total += cfg.vocab_size * cfg.d_model
    if cfg.frontend in ("frames", "patches+tokens"):
        total += cfg.frontend_dim * cfg.d_model
    if not cfg.tie_embeddings:
        total += cfg.d_model * cfg.vocab_size
    return total


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------
def _attn_score_flops(cfg: ArchConfig, kind: str, n_tokens: int, seq: int,
                      kv_len: int) -> float:
    """scores + PV einsum FLOPs for n_tokens query tokens."""
    a = cfg.attn
    if kind == ATTN_MLA:
        qk = a.qk_nope_dim + a.qk_rope_dim
        per_tok = 2.0 * a.num_q_heads * (qk + a.v_head_dim) * kv_len
        return n_tokens * per_tok
    eff_kv = min(kv_len, a.window) if (kind == ATTN_SLIDING and a.window) else kv_len
    return n_tokens * 4.0 * a.num_q_heads * a.head_dim * eff_kv


def _mixer_matmul_flops_per_token(cfg: ArchConfig, kind: str) -> float:
    """projection-side FLOPs per token (2 * mixer matmul params, plus the
    state-recurrence term for SSM/RWKV)."""
    d = cfg.d_model
    base = 2.0 * _mixer_params(cfg, kind)
    if kind == MAMBA:
        m = cfg.mamba
        di = m.expand * d
        base += 6.0 * di * m.d_state                    # a*h+b and C·h per token
    if kind == RWKV6:
        hd = cfg.rwkv.head_dim
        base += 3.0 * 2.0 * d * hd                      # r@S, kv outer, decay*S
    return base


def step_flops(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Returns {'fwd', 'train' (3x + remat), 'decode' per-step} global FLOPs."""
    B = shape.global_batch
    if shape.kind == "decode":
        n_new, seq, kv = B, 1, shape.seq_len
    else:
        n_new = B * shape.seq_len
        seq = kv = shape.seq_len

    fwd = 0.0
    for mk, fk in cfg.pattern():
        fwd += n_new * _mixer_matmul_flops_per_token(cfg, mk)
        if mk in (ATTN_FULL, ATTN_SLIDING, ATTN_MLA):
            causal_factor = 0.5 if (shape.kind != "decode"
                                    and not cfg.is_encoder_only) else 1.0
            fwd += causal_factor * _attn_score_flops(cfg, mk, n_new, seq, kv)
        fwd += n_new * 2.0 * _ffn_params(cfg, fk, active_only=True)
    # embedding head
    fwd += n_new * 2.0 * cfg.d_model * cfg.vocab_size
    if cfg.frontend == "frames":
        fwd += n_new * 2.0 * cfg.frontend_dim * cfg.d_model

    return {
        "fwd": fwd,
        "train": 4.0 * fwd,            # fwd + 2x bwd + 1x remat recompute
        "train_noremat": 3.0 * fwd,
        "model_6nd": 6.0 * count_params(cfg, active_only=True) * n_new,
    }
