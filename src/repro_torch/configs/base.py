"""Config system: dataclass configs for models, shapes, training, FL and mesh
(a copy of ``repro.configs.base``; the port imports nothing of ``repro``).

Every assigned architecture lives in ``src/repro_torch/configs/<id>.py`` (literal id
as filename, loaded via importlib) and exports ``CONFIG: ModelConfig``.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
from dataclasses import dataclass, field
from typing import Optional, Tuple

CONFIG_DIR = pathlib.Path(__file__).parent


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0              # routed experts
    experts_per_token: int = 1        # top-k
    num_shared_experts: int = 0
    d_ff_expert: int = 0              # per-expert hidden dim
    router_aux_loss: float = 0.01     # load-balance loss weight
    capacity_factor: float = 1.25
    moe_every: int = 1                # k: every k-th block is MoE (Llama 4
    #                                   Maverick interleaves 1 MoE : 1 dense)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0              # 0 => full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD configuration."""
    state_dim: int = 64
    head_dim: int = 64                # Mamba2 P
    expand: int = 2                   # d_inner = expand * d_model
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM: indices of sLSTM blocks; the rest are mLSTM."""
    slstm_every: int = 0              # 0 => all mLSTM; k => every k-th block sLSTM
    proj_factor: float = 2.0          # mLSTM up-projection factor


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 => d_model // num_heads
    # attention
    rope_theta: float = 10000.0
    window: int = 0                   # 0 => full attention; >0 => sliding window
    causal: bool = True
    # hybrid (zamba2): one *shared* attention block applied every `attn_every`
    # mamba blocks (shared weights, Zamba-style).
    attn_every: int = 0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # enc-dec (audio): decoder layer count; num_layers is the encoder depth.
    dec_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub: >0 => inputs are precomputed embeddings of this
    # many prefix positions (vlm patches / audio frames) fed alongside tokens.
    frontend_embed_len: int = 0
    # norm / activation
    norm_eps: float = 1e-5
    act: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # notes for DESIGN/EXPERIMENTS (e.g. long_500k handling)
    notes: str = ""
    source: str = ""                  # citation

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def param_count(self) -> int:
        """Analytical parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        n = v * d                       # token embedding
        if not self.tie_embeddings:
            n += v * d                  # lm head
        n += self.num_layers * self.block_param_count()
        if self.cross_attention and self.dec_layers:
            n += self.dec_layers * self.decoder_block_param_count()
        return n

    def active_param_count(self) -> int:
        """Per-token active params (MoE counts only routed top-k + shared)."""
        d, v = self.d_model, self.vocab_size
        n = v * d + (0 if self.tie_embeddings else v * d)
        n += self.num_layers * self.block_param_count(active_only=True)
        if self.cross_attention and self.dec_layers:
            n += self.dec_layers * self.decoder_block_param_count()
        return n

    # -- per-block parameter model -------------------------------------------
    def attn_param_count(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        if self.mla is not None:
            m = self.mla
            qd = (m.qk_nope_head_dim + m.qk_rope_head_dim) * self.num_heads
            n = d * m.kv_lora_rank + m.kv_lora_rank * (
                (m.qk_nope_head_dim + m.v_head_dim) * self.num_heads)
            n += d * m.qk_rope_head_dim   # shared rope key
            n += (d * m.q_lora_rank + m.q_lora_rank * qd) if m.q_lora_rank else d * qd
            n += self.num_heads * m.v_head_dim * d
            return n
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def mlp_param_count(self, d_ff: int) -> int:
        mult = 3 if self.act == "swiglu" else 2
        return mult * self.d_model * d_ff

    def block_param_count(self, active_only: bool = False) -> int:
        d = self.d_model
        if self.family == "ssm" and self.xlstm is not None:
            d_in = int(self.xlstm.proj_factor * d)
            return 2 * d * d_in + 2 * d_in * d + 4 * d  # rough mLSTM block
        if self.ssm is not None and self.family in ("ssm", "hybrid"):
            s = self.ssm
            d_in = s.expand * d
            n_heads = d_in // s.head_dim
            mamba = (d * (2 * d_in + 2 * s.state_dim * (d_in // s.head_dim if False else 1) )  # simplified
                     )
            # canonical mamba2: in_proj d->(2*d_in + 2*n_groups*state + n_heads)
            mamba = d * (2 * d_in + 2 * s.state_dim + n_heads) + d_in * d + 2 * d
            if self.family == "hybrid":
                # shared attention block amortized over attn_every mamba blocks
                if self.attn_every:
                    shared = self.attn_param_count() + self.mlp_param_count(self.d_ff)
                    mamba += shared // max(1, self.num_layers)
                return mamba
            return mamba
        attn = self.attn_param_count()
        if self.moe is not None and self.moe.num_experts > 0:
            experts = self.moe.num_experts
            active = self.moe.experts_per_token
            shared = self.moe.num_shared_experts
            e_ff = self.moe.d_ff_expert or self.d_ff
            per_e = self.mlp_param_count(e_ff)
            router = self.d_model * experts
            total_e = experts if not active_only else active
            moe_block = attn + router + (total_e + shared) * per_e \
                + 2 * self.d_model
            k = max(1, self.moe.moe_every)
            if k > 1:   # interleaved: (k-1) dense blocks per MoE block
                dense_block = attn + self.mlp_param_count(self.d_ff) \
                    + 2 * self.d_model
                return (moe_block + (k - 1) * dense_block) // k
            return moe_block
        return attn + self.mlp_param_count(self.d_ff) + 2 * self.d_model

    def decoder_block_param_count(self) -> int:
        return self.attn_param_count() * 2 + self.mlp_param_count(self.d_ff) + 3 * self.d_model


@dataclass(frozen=True)
class GroupedSSMConfig(SSMConfig):
    """Mamba2 with ``n_groups`` groups of B and C (``ngroups``): head h
    reads group h // (heads / n_groups), and the gated RMSNorm normalises
    each group's run of ``d_inner / n_groups`` channels apart. A field of
    its own class, so that the JAX package's configs keep their fields."""
    n_groups: int = 1


@dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """Zamba2 at its published layout (arXiv:2411.15242; the ``zamba2``
    topology of ``models/lm.py``), beside the JAX package's ``zamba`` one:
    ``num_layers`` Mamba2 layers, and at each layer of
    ``hybrid_layer_ids`` (use i) one of ``num_mem_blocks`` shared blocks (i
    mod ``num_mem_blocks``) over the stream joined to the token embedding
    (2 d wide, ``num_heads`` heads of ``head_dim`` = 2 d / heads), whose
    output, through use i's own LoRA on the MLP's gate-up product (rank
    ``adapter_rank``) and its own d x d projection, enters that layer's
    Mamba2 input only. As published, q.k is scaled by (head_dim / 2)^-0.5
    and the embedding is not scaled by sqrt(d) (the ``zamba2`` topology
    does both); a layer-wise stage is ``stage_layers`` layers. ``act``
    "geglu" is the shared MLP's exact (erf) GELU gate."""
    hybrid_layer_ids: Tuple[int, ...] = ()
    num_mem_blocks: int = 1
    adapter_rank: int = 0
    stage_layers: int = 6

    def param_count(self) -> int:
        """Every parameter of the layout, the tied embedding once."""
        d, s, f = self.d_model, self.ssm, self.d_ff
        di = s.expand * d
        G = getattr(s, "n_groups", 1)
        H, conv = di // s.head_dim, di + 2 * G * s.state_dim
        mamba = d * (di + conv + H) + di * d + s.conv_width * conv + conv \
            + 3 * H + di + d
        width = self.num_heads * self.resolved_head_dim
        shared = 2 * d + 3 * 2 * d * width + width * d + d + 3 * d * f
        use = d * d + self.adapter_rank * (d + 2 * f)
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2) + d
        return n + self.num_layers * mamba + self.num_mem_blocks * shared \
            + len(self.hybrid_layer_ids) * use


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Training / FL configuration (the paper's experiment knobs)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"          # adamw | adafactor | sgdm
    base_lr: float = 1.5e-4
    weight_decay: float = 1e-5
    lr_schedule: str = "cosine"       # cosine | fixed | cyclic   (paper §5.9)
    batch_size: int = 1024
    warmup_steps: int = 0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    grad_clip: float = 0.0
    remat: bool = False
    microbatch: int = 0               # 0 => no grad accumulation


@dataclass(frozen=True)
class SSLConfig:
    method: str = "moco_v3"           # moco_v3 | simclr | byol
    temperature: float = 0.2
    momentum: float = 0.99
    proj_dim: int = 256
    proj_hidden: int = 4096
    pred_hidden: int = 4096
    align_weight: float = 0.01        # alpha (representation alignment)


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 10
    clients_per_round: int = 0        # 0 => all
    rounds: int = 180
    local_epochs: int = 3
    # schedule: e2e | layerwise | lw_fedssl | progressive | fll_dd
    schedule: str = "lw_fedssl"
    rounds_per_stage: Tuple[int, ...] = ()   # empty => uniform R/S
    stage_allocation: str = "uniform"        # uniform | left_skewed | right_skewed
    weight_transfer: bool = True             # L_{s-1} -> L_s init (paper §B.2)
    depth_dropout: float = 0.0               # FLL+DD frozen-layer drop rate
    include_heads: bool = True               # exchange SSL heads; False =
    #                                          encoder-only wire/accounting
    #                                          (heads revert to the server
    #                                          copy each round — the sim
    #                                          keeps no per-client state)
    server_epochs: int = 3                   # server-side calibration epochs
    aux_fraction: float = 0.1                # |D_g| as fraction (paper §5.4)
    dirichlet_beta: float = 0.0              # 0 => IID partition
    seed: int = 0


# ---------------------------------------------------------------------------
# Registry: load src/repro/configs/<id>.py by literal arch id
# ---------------------------------------------------------------------------
ARCH_IDS = [
    # the LM architectures, every one of the JAX package's
    "zamba2-2.7b",
    "internlm2-1.8b",
    "internvl2-1b",
    "mistral-large-123b",
    "internlm2-20b",
    "starcoder2-15b",
    "xlstm-125m",
    "seamless-m4t-medium",
    "llama4-maverick-400b-a17b",
    "deepseek-v2-236b",
    # the paper's own backbone
    "vit-tiny",
]

_cache: dict = {}


def load_arch(arch_id: str) -> ModelConfig:
    if arch_id in _cache:
        return _cache[arch_id]
    path = CONFIG_DIR / f"{arch_id}.py"
    if not path.exists():
        raise KeyError(f"unknown arch '{arch_id}'; available: {ARCH_IDS}")
    spec = importlib.util.spec_from_file_location(
        f"repro_torch.configs._arch_{arch_id.replace('-', '_').replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    cfg = mod.CONFIG
    _cache[arch_id] = cfg
    return cfg


def load_train(arch_id: str) -> "TrainConfig":
    """Per-arch training config (optimizer/remat/microbatch) or defaults."""
    path = CONFIG_DIR / f"{arch_id}.py"
    spec = importlib.util.spec_from_file_location(
        f"repro_torch.configs._train_{arch_id.replace('-', '_').replace('.', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # type: ignore[union-attr]
    return getattr(mod, "TRAIN", TrainConfig())


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=2 layers, d<=512)."""
    base = dict(
        num_layers=2,
        d_model=min(cfg.d_model, 256),
        num_heads=min(cfg.num_heads, 4),
        num_kv_heads=min(cfg.num_kv_heads, 2),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=64 if cfg.head_dim else 0,
        dec_layers=2 if cfg.dec_layers else 0,
        frontend_embed_len=min(cfg.frontend_embed_len, 16),
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.moe is not None:
        base["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, 4),
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff_expert=min(cfg.moe.d_ff_expert or 512, 256))
    if cfg.mla is not None:
        base["mla"] = MLAConfig(kv_lora_rank=64, q_lora_rank=0,
                                qk_nope_head_dim=32, qk_rope_head_dim=16,
                                v_head_dim=32)
    if cfg.ssm is not None:
        base["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=32,
                                          chunk_size=32)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
