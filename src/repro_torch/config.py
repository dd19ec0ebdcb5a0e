"""Config system: frozen dataclasses plus a registry keyed by ``--arch`` or
``--snn`` id (the PyTorch counterpart of ``repro.config``).

Every selectable architecture is a module in ``repro_torch.configs`` that
registers one config: the 10 LM architectures (``ArchConfig``, found by
``get_arch``) and the paper's two SNNs (``SNNConfig``, found by
``get_snn``).  The fields, the registry functions, ``reduced`` and the LM
shapes (``LM_SHAPES``: train_4k / prefill_32k / decode_32k / long_500k)
are the reference's, so every (arch x shape) cell is well defined.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

__all__ = [
    "ATTN_FULL", "ATTN_SLIDING", "ATTN_MLA", "MAMBA", "RWKV6", "FFN_DENSE",
    "FFN_MOE", "MoEConfig", "MambaConfig", "RWKVConfig", "AttnConfig",
    "Stage", "ArchConfig", "ShapeConfig", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "LM_SHAPES", "SHAPES_BY_NAME", "SNNConfig",
    "register", "register_snn", "get_arch", "get_snn", "list_archs",
    "list_snns", "reduced",
]

# ---------------------------------------------------------------------------
# Layer-pattern vocabulary of the transformer stack.
# ---------------------------------------------------------------------------
ATTN_FULL = "attn_full"          # global softmax attention (GQA-parameterized)
ATTN_SLIDING = "attn_sliding"    # sliding-window (local) attention
ATTN_MLA = "attn_mla"            # DeepSeek multi-head latent attention
MAMBA = "mamba"                  # Mamba-1 selective SSM block
RWKV6 = "rwkv6"                  # RWKV-6 time-mix (data-dependent decay)
FFN_DENSE = "ffn_dense"          # dense (possibly gated) FFN
FFN_MOE = "ffn_moe"              # routed mixture-of-experts FFN


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                     # per-expert FFN hidden dim
    num_shared: int = 0               # DeepSeek-style always-on shared experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 128                  # chunked-scan chunk length


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    chunk: int = 128
    d_ffn: int = 0                    # channel-mix hidden (0 -> use arch d_ff)


@dataclass(frozen=True)
class AttnConfig:
    num_q_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: int = 0                   # sliding window size (ATTN_SLIDING)
    rope_theta: float = 10_000.0
    # MLA (only for ATTN_MLA)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0
    logit_softcap: float = 0.0


# A "stage" is (repeats, sub_pattern): the model runs `repeats` times over
# the `sub_pattern` of (mixer, ffn) sublayers, so periodic interleaves
# (gemma3 5 local:1 global, jamba 1 attn:7 mamba) are stated once.
Stage = Tuple[int, Tuple[Tuple[str, str], ...]]


@dataclass(frozen=True)
class ArchConfig:
    """A full LM-family architecture description."""
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm | snn
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    stages: Optional[Tuple[Stage, ...]] = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    is_encoder_only: bool = False     # hubert: no causal mask, no decode
    frontend: str = "tokens"          # tokens | frames (audio stub) | patches+tokens (vlm stub)
    frontend_dim: int = 0             # embedding dim delivered by the stub frontend
    num_patches: int = 0              # vlm: image patches prepended to the text sequence
    dtype: str = "bfloat16"
    source: str = ""

    def stage_list(self) -> Tuple[Stage, ...]:
        if self.stages is not None:
            return self.stages
        kind = (ATTN_FULL, FFN_MOE if self.moe else FFN_DENSE)
        return ((self.num_layers, (kind,)),)

    def pattern(self) -> Tuple[Tuple[str, str], ...]:
        pat: list = []
        for repeats, sub in self.stage_list():
            pat.extend(list(sub) * repeats)
        if len(pat) != self.num_layers:
            raise ValueError(f"{self.name}: stages give {len(pat)} layers, "
                             f"num_layers is {self.num_layers}")
        return tuple(pat)

    def param_count(self) -> int:
        """Analytic total parameter count (``models.counting``)."""
        from repro_torch.models.counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_params
        return count_params(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode
    # decode shapes: seq_len is the KV-cache length; the step consumes 1 token.


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
LM_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in LM_SHAPES}


@dataclass(frozen=True)
class SNNConfig:
    """The paper's spiking networks (classification & segmentation)."""
    name: str
    input_hw: Tuple[int, int]
    input_channels: int
    # conv spec: list of (out_channels, kernel R); APRC turns these into
    # full-pad stride-1 convs. Classification net appends dense heads.
    conv_channels: Tuple[int, ...]
    kernel_size: int
    dense_units: Tuple[int, ...]      # trailing dense layers (e.g. (10,))
    timesteps: int
    v_threshold: float = 1.0
    aprc: bool = True                 # full-pad stride-1 structural change
    num_spe_clusters: int = 8         # M in Algorithm 1
    num_spes_per_cluster: int = 4     # N in Algorithm 1
    source: str = ""


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
_REGISTRY: dict = {}
_SNN_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def register_snn(cfg: SNNConfig) -> SNNConfig:
    _SNN_REGISTRY[cfg.name] = cfg
    return cfg


def _ensure_loaded() -> None:
    import repro_torch.configs  # noqa: F401  (import side-effect populates registry)


def get_arch(name: str) -> ArchConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def get_snn(name: str) -> SNNConfig:
    _ensure_loaded()
    if name not in _SNN_REGISTRY:
        raise KeyError(f"unknown SNN {name!r}; have {sorted(_SNN_REGISTRY)}")
    return _SNN_REGISTRY[name]


def list_archs() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def list_snns() -> Sequence[str]:
    _ensure_loaded()
    return sorted(_SNN_REGISTRY)


def reduced(cfg: ArchConfig, **overrides: Any) -> ArchConfig:
    """A smoke-test-sized config of the same family (tiny dims, same pattern
    kinds)."""
    d_model = overrides.pop("d_model", 64)
    head_dim = 16
    # shrink stages: keep every distinct sublayer kind, cap repeats at 2
    new_stages = tuple((min(r, 2), sub) for r, sub in cfg.stage_list())
    num_layers = sum(r * len(sub) for r, sub in new_stages)
    changes: dict = dict(
        num_layers=num_layers,
        stages=new_stages,
        d_model=d_model,
        d_ff=overrides.pop("d_ff", 128),
        vocab_size=overrides.pop("vocab_size", 256),
        frontend_dim=d_model if cfg.frontend_dim else 0,
        num_patches=min(cfg.num_patches, 4) if cfg.num_patches else 0,
    )
    if cfg.attn is not None:
        nq = max(2, min(4, cfg.attn.num_q_heads))
        nkv = max(1, min(2, cfg.attn.num_kv_heads))
        mla = cfg.attn.q_lora_rank > 0 or cfg.attn.kv_lora_rank > 0
        changes["attn"] = dataclasses.replace(
            cfg.attn,
            num_q_heads=nq, num_kv_heads=nkv, head_dim=head_dim,
            window=min(cfg.attn.window, 32) if cfg.attn.window else 0,
            q_lora_rank=32 if mla and cfg.attn.q_lora_rank else 0,
            kv_lora_rank=32 if mla else 0,
            qk_rope_dim=8 if mla else 0,
            qk_nope_dim=16 if mla else 0,
            v_head_dim=16 if mla else 0,
        )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=8, top_k=min(2, cfg.moe.top_k), d_expert=32,
            num_shared=min(1, cfg.moe.num_shared))
    if cfg.mamba is not None:
        changes["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=16)
    if cfg.rwkv is not None:
        changes["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=16, chunk=16)
    changes.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-reduced", **changes)
