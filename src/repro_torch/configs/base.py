"""The port's configurations, copies of the JAX package's
``configs/base.py``: the language models' ``ModelConfig`` with its block
kinds and sub-configs (``:14-200``), the input shapes (``ShapeConfig``,
``SHAPES``), the federated-learning ``FedConfig`` (``:205-294``) and the
fleet's ``HeteroConfig`` (``:297-325``), with every field, so configs are
built the same way for both packages.

``FedConfig.use_pallas`` picks the LM forward's route in the pod engine
(``launch/train.py`` passes it to the model's forward, as the reference
does): the flash attention and SSD kernels, or their plain versions.  The
update, wire and KD kernels run on every CUDA tensor whatever it says.
``RunConfig`` is the pod engine's run (its mesh fields kept for parity:
the port runs on one card).  The LM stack builds every block kind and
every architecture of ``configs/``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block kinds used to assemble heterogeneous stacks (hybrid / ssm / enc-dec).
# ---------------------------------------------------------------------------
ATTN = "attn"          # self-attention transformer block
MOE = "moe"            # transformer block with MoE FFN
MAMBA2 = "mamba2"      # Mamba2 (SSD) block
SLSTM = "slstm"        # xLSTM sLSTM block (scalar memory, sequential)
MLSTM = "mlstm"        # xLSTM mLSTM block (matrix memory, parallel)
SHARED_ATTN = "shared_attn"  # Zamba2-style globally shared attention block


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    top_k: int = 1
    n_shared_experts: int = 0     # always-on shared experts
    d_ff_expert: int = 0          # per-expert hidden dim
    router_aux_coef: float = 0.001  # load-balance auxiliary loss
    first_k_dense: int = 0        # leading layers that stay dense (DeepSeek)
    capacity_factor: float = 1.25  # per-expert token capacity (dropless if <=0)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / xLSTM recurrent block parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    n_groups: int = 1
    head_dim: int = 64
    chunk_size: int = 256         # SSD chunk length (TPU matmul-friendly)


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str = "unnamed"
    family: str = "dense"         # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""              # citation for the config

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: int = 0             # 0 => d_model // n_heads
    max_seq_len: int = 8192

    # attention variants
    qk_norm: bool = False         # Qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False        # Qwen1.5-style bias on qkv projections
    rope_theta: float = 10000.0
    sliding_window: int = 0       # 0 => full attention
    # iRoPE-style interleave: every `global_attn_every`-th layer uses full
    # attention, the rest use `sliding_window` (Llama-4 chunked attention).
    global_attn_every: int = 0
    mla: Optional[MLAConfig] = None

    # MoE / SSM
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None

    # stack layout.  If `block_pattern` is empty it defaults to n_layers of
    # ATTN (or MOE for moe family).  For hybrids it lists one entry per layer.
    block_pattern: Tuple[str, ...] = ()
    shared_attn_every: int = 0    # Zamba2: shared block after every k blocks

    # enc-dec (audio): encoder consumes stub frame embeddings.
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq_scale: int = 1    # encoder frames per decoder token budget

    # vlm: prefix of precomputed patch embeddings (stub vision tower).
    n_patch_tokens: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # which mesh axis the MoE dispatch buffers live on: "model" for the
    # training regime (FSDP over data), "data" for the serving regime
    # (expert-parallel over data, no param gathers) — §Perf iteration 6
    moe_dispatch_axis: str = "model"

    # --- derived ----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        # explicit 0-sentinel comparison, not truthiness (truthiness-on-config)
        return self.head_dim if self.head_dim > 0 \
            else self.d_model // self.n_heads

    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern:
            return self.block_pattern
        if self.moe is not None:
            pat = []
            for i in range(self.n_layers):
                pat.append(ATTN if i < self.moe.first_k_dense else MOE)
            return tuple(pat)
        return (ATTN,) * self.n_layers

    def layer_uses_window(self, layer_idx: int) -> bool:
        """True when this attention layer is sliding-window (sub-quadratic)."""
        if self.sliding_window <= 0:
            return False
        if self.global_attn_every > 0:
            return (layer_idx + 1) % self.global_attn_every != 0
        return True

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode possible (SSM/hybrid, or windowed attention
        on every layer that would otherwise be quadratic)."""
        kinds = set(self.blocks())
        attn_kinds = {ATTN, MOE, SHARED_ATTN}
        if not (kinds & attn_kinds):
            return True                           # pure SSM
        if self.is_encoder_decoder:
            return False
        if MAMBA2 in kinds or MLSTM in kinds or SLSTM in kinds:
            # hybrid: the SSM backbone carries long-range state; the few
            # (shared) attention layers decode linearly against the cache
            return True
        if self.mla is not None:
            return False                          # full-attention MLA cache
        if self.sliding_window > 0:
            # hybrids: the few attention layers are windowed; dense: every
            # layer must be windowed unless interleaved global layers use
            # attention-sink truncation (we do not), so require no globals
            # or an SSM backbone carrying the long-range state.
            if self.global_attn_every == 0:
                return True
            return MAMBA2 in kinds or MLSTM in kinds or self.family == "moe"
        return False

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        from repro_torch.models.registry import count_params  # lazy
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.registry import count_params
        return count_params(self, active_only=True)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        kw = dict(
            n_layers=2, d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            d_ff=min(self.d_ff, 512) if self.d_ff > 0 else 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=256,
            head_dim=64 if self.head_dim > 0 else 0,
        )
        kw["n_kv_heads"] = min(self.n_kv_heads, kw["n_heads"])
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                first_k_dense=min(self.moe.first_k_dense, 1))
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=min(self.ssm.d_state, 16),
                                head_dim=32, chunk_size=64)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=48,
                                  qk_nope_head_dim=32, qk_rope_head_dim=16,
                                  v_head_dim=32)
        if self.block_pattern:
            kw["block_pattern"] = self.block_pattern[:2]
        if self.is_encoder_decoder:
            kw["n_encoder_layers"] = 2
        if self.n_patch_tokens > 0:
            kw["n_patch_tokens"] = 16
        if self.sliding_window > 0:
            kw["sliding_window"] = min(self.sliding_window, 128)
        return replace(self, **kw)




@dataclass(frozen=True)
class FedConfig:
    strategy: str = "fedadc"       # fedadc|fedadc_double|slowmo|fedavg|fedprox|
                                   # feddyn|scaffold|moon|fedgkd|fedntd|fedrs
    variant: str = "nesterov"      # fedadc: nesterov (red) | heavyball (blue)
    local_steps: int = 8           # H
    clients_per_round: int = 8     # |S_t|
    n_clients: int = 100           # N
    participation: float = 0.2     # c  (used by samplers)
    eta: float = 0.05              # local lr
    alpha: float = 1.0             # server lr multiplier
    beta_global: float = 0.8       # SlowMo / FedADC global momentum
    beta_local: float = 0.8        # FedADC embedding discount
    phi: float = 0.9               # double-momentum local EMA
    mu_prox: float = 0.01          # FedProx proximal coefficient
    feddyn_alpha: float = 0.01     # FedDyn regularization
    # self knowledge distillation (FedADC+)
    distill: bool = False
    distill_lambda: float = 0.35
    distill_tau: float = 1.0
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    use_pallas: bool = False       # the LM forward's kernel route (pod engine)
    # server-side aggregation: uniform | examples | drag
    aggregator: str = "uniform"
    drag_lambda: float = 4.0       # DRAG divergence temperature
    # semi-async engine
    buffer_k: int = 0              # server update after K deltas; 0 =>
                                   # clients_per_round (synchronous barrier)
    staleness_mode: str = "poly"   # none | poly ((1+s)^-a) | exp (a^s)
    staleness_factor: float = 0.5  # `a` in the discount above
    # uplink delta compression: none bypasses the codec entirely; identity
    # goes through it losslessly; topk/qsgd are lossy with per-client EF
    compressor: str = "none"       # none | identity | topk | qsgd
    topk_frac: float = 0.1         # fraction of entries kept per leaf
    qsgd_bits: int = 8             # magnitude bits (sign sent separately)
    error_feedback: bool = True    # re-inject round-t residual at t+1
    # sparse (value, index) top-k wire, and sparse-native aggregation of it
    sparse_uplink: bool = False
    sparse_aggregate: bool = True
    # downlink broadcast compression
    downlink_compressor: str = "none"   # none | identity | topk | qsgd |
                                        # delta[+identity|+topk|+qsgd]
    downlink_topk_frac: Optional[float] = None
    downlink_qsgd_bits: Optional[int] = None
    # per-client unicast downlink
    downlink_unicast: bool = False
    resync_horizon: int = 4
    # two-tier fleet topology: 0 = flat aggregation, R >= 1 = hierarchical
    # (``federated/fleet``: R contiguous regional reduces, then one fp32
    # combine of the partials; R = 1 is bit for bit the flat aggregate)
    fleet_regions: int = 0


# ---------------------------------------------------------------------------
# Client system heterogeneity (``federated/hetero.py``): the fleet's compute
# speeds, availability and variable local work, as opposed to FedConfig,
# which describes the algorithm.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HeteroConfig:
    enabled: bool = False
    # compute-speed distribution over clients:
    #   constant  — all clients speed 1 (the synchronous idealisation)
    #   lognormal — exp(sigma·N(0,1)), long right tail of slow clients
    #   uniform   — U[speed_range]
    #   bimodal   — straggler_frac of clients run straggler_slowdown× slower
    speed_dist: str = "constant"
    speed_sigma: float = 0.5
    speed_range: Tuple[float, float] = (0.25, 1.0)
    straggler_frac: float = 0.25
    straggler_slowdown: float = 4.0
    # per-client local work H_i sampled uniformly from this set; () => every
    # client runs fed.local_steps (homogeneous work).
    local_steps_choices: Tuple[int, ...] = ()
    # FedNova-style normalisation: rescale Δ_i by H_ref/H_i so heterogeneous
    # local work aggregates without objective inconsistency.
    fednova: bool = True
    availability: float = 1.0      # P(client reachable at dispatch time)
    drop_prob: float = 0.0         # P(in-flight client drops; delta lost)
    time_jitter: float = 0.0       # multiplicative jitter on round times
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"            # train | prefill | decode


# The four assigned input shapes.
SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class RunConfig:
    mesh_shape: Tuple[int, ...] = (16, 16)
    mesh_axes: Tuple[str, ...] = ("data", "model")
    multi_pod: bool = False
    remat: str = "none"            # none | full | selective
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    seed: int = 0
