"""Config dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``; every assigned
input shape as a ``ShapeConfig``; a dry-run / benchmark cell is the product
``Cell = (ModelConfig, ShapeConfig, MeshConfig)``.

Layer composition is expressed as a *block pattern*: the model is
``first_k_dense`` standalone layers followed by ``n_blocks`` repetitions of
``block_pattern`` (a tuple of layer kinds), scanned with ``jax.lax.scan`` so
the HLO stays small for the 40-cell dry-run.

Layer kinds:
  attn_mlp    self-attention + dense MLP           (llama/qwen/gemma/seamless enc)
  attn_mlp_local  sliding-window self-attn + MLP   (gemma2 'local' layers)
  attn_moe    self-attention + MoE FFN             (olmoe, kimi)
  xattn_mlp   gated cross-attention + dense MLP    (llama-3.2-vision)
  cross_mlp   self-attn + cross-attn + dense MLP   (seamless decoder)
  mamba / mamba_moe   Mamba mixer + dense/MoE FFN  (jamba)
  attn / attn_moe_j   attention inside jamba block
  rwkv        RWKV-6 time-mix + channel-mix        (rwkv6)
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    experts_per_token: int
    d_ff: int                       # per-expert hidden width
    n_shared_experts: int = 0       # always-on shared experts (kimi-k2 style)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective SSM (used by jamba)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2                 # d_inner = expand * d_model
    dt_rank: int = 0                # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # layer composition (see module docstring)
    block_pattern: Tuple[str, ...] = ("attn_mlp",)
    first_k_dense: int = 0          # standalone dense attn_mlp layers before the scan

    # attention details
    d_head: int = 0                 # 0 -> d_model // n_heads
    rope_theta: float = 10_000.0
    qkv_bias: bool = False          # qwen2
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    logit_softcap: Optional[float] = None   # gemma2: 30.0
    sliding_window: Optional[int] = None    # gemma2: 4096 on 'local' layers
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma2: x *= sqrt(d_model)
    norm_eps: float = 1e-5
    act: str = "silu"               # silu | gelu | relu

    # mixture of experts
    moe: Optional[MoEConfig] = None

    # ssm (jamba)
    ssm: Optional[SSMConfig] = None

    # encoder-decoder (seamless)
    n_enc_layers: int = 0           # >0 -> enc-dec; n_layers is the decoder depth
    enc_block_pattern: Tuple[str, ...] = ("attn_mlp",)

    # vlm (llama-3.2-vision): number of precomputed image-embedding tokens
    n_image_tokens: int = 0

    # numerics / execution
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: str = "full"             # none | dots | full
    scan_blocks: bool = True        # scan over block_pattern repetitions
    unroll_scans: bool = False      # unroll inner seq scans (roofline cost runs)
    flash_q_chunk: int = 512        # flash attention q block
    flash_kv_chunk: int = 1024      # flash attention kv block
    use_pallas: bool = False        # opt-in TPU kernels (CPU uses pure-JAX paths)
    # decode-attention backend: "jax" (pure-JAX gather path) or "pallas"
    # (kernels/paged_attention scalar-prefetch kernel on the decode hot
    # path — interpret-mode off-TPU, real kernel on TPU).
    decode_backend: str = "jax"
    # Warm prefix-cache tuning (serving): eviction policy of the
    # cross-request PrefixIndex and an optional cap on the pages it may
    # retain after release (0 = bounded only by pool pressure). gdsfs is
    # the size-aware score (frequency x covered-tokens / page-span).
    prefix_cache_policy: str = "lru"        # lru | lfu | gdsfs
    prefix_cache_pages: int = 0
    # Online prefix-cache cap tuning: window length in decode steps after
    # which the cap shrinks/grows from live pool pressure (free-page
    # headroom vs eviction-vs-reuse rates). 0 = off (static cap above).
    prefix_cache_autotune: int = 0
    # Continuous-batching scheduler (core/serving/scheduler.py):
    # per-step token budget for the mixed decode+chunked-prefill batch and
    # the per-sequence prefill chunk cap. Used when the engine runs with
    # scheduler="continuous"; validated here so every entry point agrees.
    sched_token_budget: int = 256
    sched_prefill_chunk: int = 64
    # Serving-side translation front-end geometry: the delta-upload cache
    # the PagedKVManager runs decode page gathers through (same
    # TranslationCache as the simulator's hardware IOTLB; tuned per
    # deployment via benchmarks/tlb_sweep.py — or ONLINE via
    # serve_tlb_autotune below).
    serve_tlb_entries: int = 4096
    serve_tlb_ways: int = 0                 # 0 = fully associative
    serve_tlb_policy: str = "lru"           # lru | fifo | lfu | random | gdsfs
    # Range-coalesced IOTLB entries (SPARTA-style): the max physically
    # contiguous run one entry may cover. 0 = per-page entries only
    # (bit-identical to the historical front-end); >= 2 arms coalescing —
    # translation accounting only, never data movement, so serving
    # outputs stay bit-identical range-on vs range-off.
    serve_tlb_ranges: int = 0
    # IOTLB prefetching on the decode gather stream (Kurth et al.,
    # MMU-aware DMA prefetch): none | next_page | stream, with the issue
    # degree and the stream run-ahead distance. Defaults off.
    serve_tlb_prefetch_policy: str = "none"  # none | next_page | stream
    serve_tlb_prefetch_degree: int = 2
    serve_tlb_prefetch_distance: int = 4
    # Online TLB-geometry auto-tuning: measurement-window length in decode
    # steps (0 = off). Candidates are (entries, ways, policy) triples; an
    # empty tuple uses a default entries ladder around serve_tlb_entries.
    serve_tlb_autotune: int = 0
    serve_tlb_autotune_candidates: Tuple[Tuple[int, int, str], ...] = ()
    # svasan (core/sva/sanitizer.py): shadow-state checking of the paged
    # SVA stack while serving. False still honors the REPRO_SVASAN=1
    # environment knob; True forces it on for this config.
    svasan: bool = False

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.decode_backend not in ("jax", "pallas"):
            raise ValueError(
                f"{self.name}: decode_backend={self.decode_backend!r} "
                "(expected 'jax' or 'pallas')")
        if self.prefix_cache_policy not in ("lru", "lfu", "gdsfs"):
            raise ValueError(
                f"{self.name}: prefix_cache_policy="
                f"{self.prefix_cache_policy!r} "
                "(expected 'lru', 'lfu' or 'gdsfs')")
        if self.prefix_cache_pages < 0:
            raise ValueError(
                f"{self.name}: prefix_cache_pages={self.prefix_cache_pages} "
                "(must be >= 0; 0 = uncapped)")
        if self.prefix_cache_autotune < 0:
            raise ValueError(
                f"{self.name}: prefix_cache_autotune="
                f"{self.prefix_cache_autotune} "
                "(window length in decode steps; 0 = off)")
        if self.sched_token_budget < 1:
            raise ValueError(
                f"{self.name}: sched_token_budget={self.sched_token_budget} "
                "(need >= 1)")
        if self.sched_prefill_chunk < 1:
            raise ValueError(
                f"{self.name}: sched_prefill_chunk={self.sched_prefill_chunk} "
                "(need >= 1)")
        if self.serve_tlb_policy not in ("lru", "fifo", "lfu", "random",
                                         "gdsfs"):
            raise ValueError(
                f"{self.name}: serve_tlb_policy={self.serve_tlb_policy!r} "
                "(expected lru | fifo | lfu | random | gdsfs)")
        if self.serve_tlb_prefetch_policy not in ("none", "next_page",
                                                  "stream"):
            raise ValueError(
                f"{self.name}: serve_tlb_prefetch_policy="
                f"{self.serve_tlb_prefetch_policy!r} "
                "(expected none | next_page | stream)")
        if self.serve_tlb_prefetch_degree < 1:
            raise ValueError(
                f"{self.name}: serve_tlb_prefetch_degree="
                f"{self.serve_tlb_prefetch_degree} (need >= 1)")
        if self.serve_tlb_prefetch_distance < 1:
            raise ValueError(
                f"{self.name}: serve_tlb_prefetch_distance="
                f"{self.serve_tlb_prefetch_distance} (need >= 1)")
        if self.serve_tlb_autotune < 0:
            raise ValueError(
                f"{self.name}: serve_tlb_autotune={self.serve_tlb_autotune} "
                "(window length in decode steps; 0 = off)")
        for cand in self.serve_tlb_autotune_candidates:
            if len(cand) != 3:
                raise ValueError(
                    f"{self.name}: serve_tlb_autotune_candidates entries "
                    f"are (entries, ways, policy) triples; got {cand!r}")
        if self.serve_tlb_entries < 1:
            raise ValueError(
                f"{self.name}: serve_tlb_entries={self.serve_tlb_entries} "
                "(need >= 1)")
        ways = self.serve_tlb_ways
        if ways < 0 or ways > self.serve_tlb_entries or \
                (ways and self.serve_tlb_entries % ways):
            raise ValueError(
                f"{self.name}: serve_tlb_ways={ways} must divide "
                f"serve_tlb_entries={self.serve_tlb_entries} "
                "(0 = fully associative)")
        if self.serve_tlb_ranges < 0 or self.serve_tlb_ranges == 1:
            raise ValueError(
                f"{self.name}: serve_tlb_ranges={self.serve_tlb_ranges} "
                "(0 = off, else the max coalesced run length, >= 2)")
        blk = len(self.block_pattern)
        body = self.n_layers - self.first_k_dense
        if body % blk != 0:
            raise ValueError(
                f"{self.name}: n_layers-first_k_dense={body} not divisible by "
                f"block_pattern length {blk}")

    @property
    def n_blocks(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.block_pattern)

    @property
    def n_q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_attention_free(self) -> bool:
        kinds = set(self.block_pattern)
        return kinds <= {"rwkv"}

    @property
    def has_subquadratic_path(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / local-global alternating)."""
        kinds = set(self.block_pattern)
        if kinds <= {"rwkv"}:
            return True
        if "mamba" in kinds or "mamba_moe" in kinds:
            return True
        if self.sliding_window is not None:   # gemma2 local/global alternation
            return True
        return False

    def layer_kinds(self) -> Tuple[str, ...]:
        """Full per-layer kind list (first_k_dense + repeated pattern)."""
        return ("attn_mlp",) * self.first_k_dense + self.block_pattern * self.n_blocks


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode
    # decode shapes: seq_len is the KV-cache length; one new token is decoded.

    @property
    def lowers(self) -> str:
        return "train_step" if self.kind == "train" else "serve_step"


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


SINGLE_POD = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    zero1: bool = True              # shard optimizer state over the data axis
    grad_compression: str = "none"  # none | int8_ef (error-feedback int8)
    microbatches: int = 1           # >1 -> gradient accumulation


@dataclass(frozen=True)
class PagedKVConfig:
    """The paper's technique, as serving-runtime configuration."""
    page_size: int = 64             # tokens per physical page ("AXI burst"/block)
    table_levels: int = 1           # 1 = flat block table; 2/3 = radix walk
    offload_mode: str = "zero_copy"  # zero_copy (map) | copy (staging, baseline)
    table_residency: str = "smem"   # smem (scalar-prefetch, ~LLC-on) | hbm (~LLC-off)
    max_pages_per_seq: int = 0      # 0 -> derived from shape


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (structure preserved)."""
    kw = dict(
        n_layers=cfg.first_k_dense + len(cfg.block_pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=128,
        vocab_size=512,
        param_dtype="float32",
        activation_dtype="float32",
        scan_blocks=cfg.scan_blocks,
        sliding_window=8 if cfg.sliding_window else None,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, n_experts=4, experts_per_token=2, d_ff=32)
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=4, d_conv=4)
    if cfg.n_enc_layers:
        kw["n_enc_layers"] = 2
    if cfg.n_image_tokens:
        kw["n_image_tokens"] = 8
    return replace(cfg, **kw)


def model_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (for 6*N*D roofline term)."""
    d, dff, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    dh, hq, hkv = cfg.d_head, cfg.n_heads, cfg.n_kv_heads

    def attn_p():
        return d * (hq * dh) + 2 * d * (hkv * dh) + (hq * dh) * d \
            + (cfg.qkv_bias and (hq + 2 * hkv) * dh or 0)

    def mlp_p(width):
        return 3 * d * width

    def moe_p(active_only=False):
        m = cfg.moe
        n = (m.experts_per_token if active_only else m.n_experts) + m.n_shared_experts
        return n * 3 * d * m.d_ff + d * m.n_experts   # + router

    def mamba_p():
        s = cfg.ssm
        d_in = s.expand * d
        dt_rank = s.dt_rank or -(-d // 16)
        return (d * 2 * d_in            # in_proj (x and z)
                + d_in * s.d_conv       # depthwise conv
                + d_in * (dt_rank + 2 * s.d_state)  # x -> dt,B,C
                + dt_rank * d_in        # dt_proj
                + d_in                  # A log diag is d_in*d_state; D is d_in
                + d_in * s.d_state
                + d_in * d)             # out_proj

    def rwkv_p():
        # time-mix: r,k,v,g,o projections + decay/ddlerp low-rank (small)
        tm = 5 * d * d + 6 * 32 * d * 2
        cm = d * dff + dff * d          # rwkv channel mix (2 mats, k/v)
        return tm + cm

    kind_p = {}
    for kind in set(cfg.layer_kinds()):
        p = 0
        if kind in ("attn_mlp", "attn_mlp_local", "attn_moe", "cross_mlp",
                    "attn", "attn_moe_j"):
            p += attn_p()
        if kind in ("xattn_mlp", "cross_mlp"):
            p += attn_p()               # cross-attention projections
        if kind in ("attn_mlp", "attn_mlp_local", "xattn_mlp", "cross_mlp",
                    "mamba", "attn"):
            p += mlp_p(dff)
        if kind in ("attn_moe", "mamba_moe", "attn_moe_j"):
            p += moe_p()
        if kind in ("mamba", "mamba_moe"):
            p += mamba_p()
        if kind == "rwkv":
            p += rwkv_p()
        kind_p[kind] = p

    total = sum(kind_p[k] for k in cfg.layer_kinds())
    if cfg.is_encdec:
        total += cfg.n_enc_layers * (attn_p() + mlp_p(dff))
    total += v * d * (1 if cfg.tie_embeddings else 2)
    return int(total)


def model_active_params(cfg: ModelConfig) -> int:
    """Active (per-token) parameters for MoE archs."""
    if cfg.moe is None:
        return model_params(cfg)
    full = model_params(cfg)
    m = cfg.moe
    inactive_per_moe = (m.n_experts - m.experts_per_token) * 3 * cfg.d_model * m.d_ff
    n_moe_layers = sum(1 for k in cfg.layer_kinds() if k.endswith("moe") or k == "attn_moe_j")
    return int(full - n_moe_layers * inactive_per_moe)
