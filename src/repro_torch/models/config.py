"""Unified model configuration covering all 10 assigned architectures.

One dataclass, family-specific sub-configs.  Every ``src/repro/configs/<id>.py``
builds one of these with the exact published numbers; smoke tests build
``cfg.smoke()`` reductions of the same family.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    #: router jitter/aux-loss weight (load balancing, standard switch loss)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256
    #: groups for B/C projections (Mamba2 'ngroups')
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    #: recurrent width (RecurrentGemma lru_width; defaults to d_model)
    width: int = 0
    d_conv: int = 4
    #: block pattern, repeated: RecurrentGemma is (rec, rec, attn)
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    enc_layers: int = 24
    #: encoder context (whisper: 1500 mel frames after the conv frontend STUB)
    enc_positions: int = 1500
    #: decoder learned-position table, sized to the largest assigned decode
    #: shape (whisper's real 448 is exceeded by decode_32k — DESIGN.md §4)
    dec_positions: int = 32_768


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 → d_model // num_heads
    qkv_bias: bool = False
    sliding_window: Optional[int] = None  # SWA (h2o-danube)
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tied_embeddings: bool = False
    #: vocab padded to this multiple for clean TP over the model axis
    vocab_multiple: int = 128
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    #: VLM: number of stub patch-embedding tokens prepended to the prompt
    vision_tokens: int = 0
    dtype: str = "bfloat16"
    #: fsdp=True shards weight 'embed' dims over data axes too (ZeRO-3);
    #: required to fit the 1T kimi config (DESIGN.md §4)
    fsdp: bool = False
    remat: str = "none"  # none | dots | full
    #: does the arch support O(1)-state / windowed decode at 500k?
    subquadratic: bool = False
    #: unroll layer scans (roofline depth-extrapolation compiles only —
    #: XLA cost_analysis counts a while-loop body once, so the dry-run
    #: compiles unrolled k/2k-depth variants and extrapolates linearly)
    scan_unroll: bool = False

    # -- §Perf hillclimb knobs (beyond-paper optimizations) -------------------
    #: pad attention head counts up to this multiple so they shard over the
    #: 16-way model axis (qwen 40→48, llava 56→64). 0 = off (baseline).
    head_pad_to: int = 0
    #: attention impl for train/prefill: "dense" materializes [S,T] scores;
    #: "chunked" scans KV blocks with an online softmax (flash-style)
    attn_impl: str = "dense"
    attn_chunk: int = 2048
    #: MoE serving: 2D expert sharding (experts over model × FFN over data)
    #: with activation-gather decode — weights stay resident instead of the
    #: FSDP per-step weight all-gather
    serve_2d: bool = False

    # -- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def _pad_heads(self, h: int) -> int:
        if self.head_pad_to <= 1 or h % self.head_pad_to == 0:
            return h
        return ((h + self.head_pad_to - 1) // self.head_pad_to) * self.head_pad_to

    @property
    def padded_heads(self) -> int:
        return self._pad_heads(self.num_heads)

    @property
    def padded_kv_heads(self) -> int:
        # keep GQA grouping integral: pad kv only if q-per-kv stays integer
        kvp = self._pad_heads(self.num_kv_heads)
        return kvp if self.padded_heads % kvp == 0 else self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def num_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, ff, hd = self.d_model, self.d_ff, self.head_dim_
        H, Kv, L, V = self.num_heads, self.num_kv_heads, self.num_layers, self.padded_vocab
        emb = V * d * (1 if self.tied_embeddings else 2)
        attn = d * (H * hd) + 2 * d * (Kv * hd) + (H * hd) * d
        if self.qkv_bias:
            attn += (H + 2 * Kv) * hd
        if self.mlp_type in ("swiglu", "geglu"):
            mlp = 3 * d * ff
        else:
            mlp = 2 * d * ff
        norms = 2 * d
        per_layer = attn + mlp + norms
        total = emb
        if self.family == "moe":
            assert self.moe is not None
            moe_mlp = self.moe.num_experts * 3 * d * self.moe.d_ff_expert + d * self.moe.num_experts
            total += L * (attn + moe_mlp + norms)
        elif self.family == "ssm":
            assert self.ssm is not None
            di = self.ssm.expand * d
            nh = di // self.ssm.head_dim
            g = self.ssm.n_groups
            in_proj = d * (2 * di + 2 * g * self.ssm.d_state + nh)
            total += L * (in_proj + di * d + self.ssm.d_conv * (di + 2 * g * self.ssm.d_state) + 2 * nh + d)
        elif self.family == "hybrid":
            assert self.rglru is not None
            w = self.rglru.width or d
            nb = max(self.num_heads, 1)
            rec = (
                d * 2 * w  # gate + x projections
                + w * d  # out projection
                + self.rglru.d_conv * w  # temporal conv
                + 2 * (w * (w // nb) + w)  # block-diagonal r/i gates + biases
                + w  # Λ
            )
            n_attn, n_rec = self.block_counts()
            total += n_rec * (rec + mlp + norms) + n_attn * per_layer
        elif self.family == "audio":
            assert self.encdec is not None
            cross = d * (H * hd) + 2 * d * (Kv * hd) + (H * hd) * d
            total += self.encdec.enc_layers * per_layer + L * (per_layer + cross + d)
            # learned positional tables (encoder frames + decoder positions)
            total += (self.encdec.enc_positions + self.encdec.dec_positions) * d
        else:  # dense / vlm
            total += L * per_layer
        return total

    def active_params(self) -> int:
        """Active parameters per token (MoE: top_k experts only)."""
        if self.family != "moe":
            return self.num_params()
        assert self.moe is not None
        d, L = self.d_model, self.num_layers
        dense_total = self.num_params()
        all_expert = L * self.moe.num_experts * 3 * d * self.moe.d_ff_expert
        act_expert = L * self.moe.top_k * 3 * d * self.moe.d_ff_expert
        return dense_total - all_expert + act_expert

    def block_counts(self) -> Tuple[int, int]:
        """(attention blocks, recurrent blocks) for hybrid configs."""
        if self.family != "hybrid":
            return (self.num_layers, 0)
        assert self.rglru is not None
        pat = self.rglru.pattern
        groups, rem = divmod(self.num_layers, len(pat))
        n_attn = groups * sum(1 for b in pat if b == "attn") + sum(
            1 for b in pat[:rem] if b == "attn"
        )
        return (n_attn, self.num_layers - n_attn)

    # -- smoke reduction -------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 4 if self.family != "hybrid" else 6),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            vocab_multiple=16,
            dtype="float32",
            fsdp=False,
            remat="none",
        )
        if self.moe:
            kw["moe"] = MoEConfig(num_experts=8, top_k=2, d_ff_expert=32)
        if self.ssm:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=8)
        if self.rglru:
            kw["rglru"] = RGLRUConfig(width=64, pattern=self.rglru.pattern, local_window=16)
        if self.encdec:
            kw["encdec"] = EncDecConfig(enc_layers=2, enc_positions=16, dec_positions=64)
        if self.vision_tokens:
            kw["vision_tokens"] = 8
        if self.sliding_window:
            kw["sliding_window"] = 16
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Assigned input shapes (one set for all LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def with_depth(cfg: ModelConfig, units: int) -> ModelConfig:
    """Depth-scaled copy (same width/sharding) with unrolled scans, for the
    dry-run's cost extrapolation. ``units`` are depth units (see depth_units)."""
    if cfg.family == "hybrid":
        return dataclasses.replace(
            cfg, num_layers=units * len(cfg.rglru.pattern), scan_unroll=True
        )
    if cfg.family == "audio":
        return dataclasses.replace(
            cfg,
            num_layers=units,
            encdec=dataclasses.replace(cfg.encdec, enc_layers=units),
            scan_unroll=True,
        )
    return dataclasses.replace(cfg, num_layers=units, scan_unroll=True)


def depth_units(cfg: ModelConfig) -> float:
    """Model depth in extrapolation units (hybrid: pattern groups — the 26-
    layer RecurrentGemma is 8.67 groups, tail approximated as fractional)."""
    if cfg.family == "hybrid":
        return cfg.num_layers / len(cfg.rglru.pattern)
    return float(cfg.num_layers)


def applicable_shapes(cfg: ModelConfig):
    """Which assigned shapes run for this arch (DESIGN.md §4 skip table)."""
    out = []
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.subquadratic:
            continue  # full-attention archs skip 500k decode
        out.append(s)
    return out
