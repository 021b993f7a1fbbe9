"""Config system: every architecture is a `ModelConfig`; experiments are
`RunConfig`s composing model + parallelism + quantization + cushion settings.

Configs are plain frozen dataclasses so they are hashable (usable as jit
static args) and serializable.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class Family(str, enum.Enum):
    DENSE = "dense"          # llama-style decoder-only
    MOE = "moe"              # top-k routed experts
    SSM = "ssm"             # xLSTM (mLSTM/sLSTM blocks)
    HYBRID = "hybrid"        # jamba: mamba + attention interleave (+ MoE)
    ENCDEC = "encdec"        # whisper-style encoder-decoder
    VLM = "vlm"              # ViT frontend (stub) + LM backbone


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Arctic-style: dense FFN residual branch in parallel with the MoE branch.
    dense_residual_ff: int = 0
    # Router options
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # GShard capacity factor; tokens over capacity are dropped (pass through
    # the residual). Set high for dropless behaviour in tests.
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Parameters for recurrent blocks (Mamba / xLSTM)."""
    kind: str = "mamba"          # "mamba" | "mlstm" | "slstm"
    d_state: int = 16            # mamba state size
    d_conv: int = 4              # causal conv width
    expand: int = 2              # inner expansion factor
    # xLSTM: ratio pattern of mLSTM:sLSTM blocks, e.g. (1, 0) = all mLSTM
    mlstm_every: int = 2         # 1 of every `mlstm_every` blocks is sLSTM


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: in every `period` layers, layers whose index %
    period is in `attn_at` are attention; others are Mamba. MoE applied on
    layers where index % moe_every == moe_offset."""
    period: int = 8
    attn_at: Tuple[int, ...] = (3,)
    moe_every: int = 2
    moe_offset: int = 1


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int = 6
    encoder_seq: int = 1500        # whisper: 30s audio -> 1500 frames
    frontend: str = "stub"         # precomputed frame embeddings


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    num_patches: int = 1024
    frontend: str = "stub"         # precomputed patch embeddings


@dataclasses.dataclass(frozen=True)
class TPLayout:
    """One rank's cut of a model served over ``size`` tensor-parallel ranks
    (``serving/engine.tp_layout``): the logical axes in ``cut`` are split
    in ``size`` equal parts, every other axis is whole on every rank. The
    axes are "heads" (query heads), "kv_heads", "d_ff" (the dense MLPs'),
    "vocab", "experts" and "inner" (the Mamba channels). ``n_heads`` is
    the whole model's query heads: with the query heads cut and the KV
    heads whole, a rank's heads map onto the whole cache's KV heads by
    it."""
    size: int
    cut: Tuple[str, ...] = ()
    n_heads: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False           # qwen-style
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    act: str = "silu"                # "silu" (gated) | "gelu" (dense ff)
    gated_mlp: bool = True
    rope_theta: float = 10000.0
    max_seq_len: int = 8192
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    dtype: str = "bfloat16"          # activation/param compute dtype
    # a tensor-parallel rank's config says which axes it holds a part of
    # (serving/engine.tp_config); None: the whole model
    tp: Optional[TPLayout] = None

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.gated_mlp:
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        emb = V * d * (1 if self.tie_embeddings else 2)

        if self.family == Family.MOE:
            assert self.moe is not None
            mlp = self.moe.num_experts * mlp_dense + d * self.moe.num_experts
            if self.moe.dense_residual_ff:
                mlp += 3 * d * self.moe.dense_residual_ff
            return L * (attn + mlp + 2 * d) + emb
        if self.family == Family.SSM:
            # xLSTM: qkv-ish projections + gates, rough
            inner = d * (self.ssm.expand if self.ssm else 2)
            blk = 4 * d * inner + 2 * d
            return L * blk + emb
        if self.family == Family.HYBRID:
            assert self.hybrid is not None and self.ssm is not None
            h = self.hybrid
            n_attn = L * len(h.attn_at) // h.period
            n_mamba = L - n_attn
            n_moe = L // h.moe_every
            n_densemlp = L - n_moe
            inner = self.d_model * self.ssm.expand
            mamba = 2 * d * inner + inner * (2 * self.ssm.d_state + 1) \
                + inner * self.ssm.d_conv + inner * d
            moe_mlp = self.moe.num_experts * mlp_dense + d * self.moe.num_experts \
                if self.moe else mlp_dense
            return (n_attn * attn + n_mamba * mamba + n_moe * moe_mlp
                    + n_densemlp * mlp_dense + L * 2 * d + emb)
        if self.family == Family.ENCDEC:
            assert self.encdec is not None
            enc = self.encdec.encoder_layers * (attn + mlp_dense + 2 * d)
            dec = L * (2 * attn + mlp_dense + 3 * d)   # self + cross attn
            return enc + dec + emb
        # DENSE / VLM backbone
        return L * (attn + mlp_dense + 2 * d) + emb

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.family not in (Family.MOE, Family.HYBRID) or self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        mlp_dense = (3 if self.gated_mlp else 2) * d * self.d_ff
        full = self.param_count()
        if self.family == Family.MOE:
            inactive = L * (self.moe.num_experts - self.moe.top_k) * mlp_dense
        else:
            n_moe = L // self.hybrid.moe_every
            inactive = n_moe * (self.moe.num_experts - self.moe.top_k) * mlp_dense
        return full - inactive


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization scheme configuration (paper §3, §5.1)."""
    mode: str = "none"       # none|pt_static|pt_dynamic|ptoken_dynamic
    w_bits: int = 8
    a_bits: int = 8
    w_group: int = 128       # group-wise symmetric weight quant (0 = per-channel)
    symmetric_w: bool = True
    symmetric_a: bool = False  # paper: asymmetric activations
    smoothquant: bool = False
    smooth_alpha: float = 0.8  # paper's migration strength
    true_int8: bool = False    # int8 dot_general (serving/roofline path) vs fake-quant


@dataclasses.dataclass(frozen=True)
class CushionConfig:
    """CushionCache discovery configuration (paper §4)."""
    max_prefix_len: int = 16
    tau: float = 0.5                 # greedy early-stop threshold, eq. (10)
    sample_len: int = 512            # calibration sample length n
    n_candidates: int = 256          # embedding-table candidates per greedy step
    seed_tokens: Tuple[int, ...] = ()  # nonsemantic init (<bos>, \n)
    lam: float = 0.01                # λ for L_pred + λ·L_q, eq. (11)
    tune_steps: int = 200
    tune_lr: float = 1e-3
    log_every: int = 10              # tuning metric host-sync cadence (steps
                                     # per blocking device->host transfer)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    multi_pod: bool = False
    dp: int = 16
    tp: int = 16
    pods: int = 2
    remat: bool = True
    zero1: bool = True
    grad_compress: bool = False   # int8 gradient all-reduce on DP/pod axes
    use_pallas: bool = False      # route matmuls through Pallas kernels (TPU)


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    quant: QuantConfig = QuantConfig()
    cushion: CushionConfig = CushionConfig()
    parallel: ParallelConfig = ParallelConfig()
    seq_len: int = 2048
    global_batch: int = 8
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup_steps: int = 100
    train_steps: int = 1000
    grad_clip: float = 1.0
    seed: int = 0


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized model of the same family (small layers/width/experts,
    tiny embedding table) used by per-arch smoke tests on CPU."""
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=(128 if cfg.d_ff else 0),
        vocab_size=256,
        max_seq_len=512,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 8),
            top_k=min(cfg.moe.top_k, 2),
            dense_residual_ff=128 if cfg.moe.dense_residual_ff else 0,
            capacity_factor=64.0)  # dropless at smoke scale
    if cfg.hybrid is not None:
        kw["n_layers"] = cfg.hybrid.period  # one full period
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(
            cfg.encdec, encoder_layers=2, encoder_seq=32)
    if cfg.vlm is not None:
        kw["vlm"] = dataclasses.replace(cfg.vlm, num_patches=16)
    kw.update(overrides)
    return dataclasses.replace(cfg, **kw)
