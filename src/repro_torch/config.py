"""Configuration of the port's model, training and parallel layout.

The port's own copy of the JAX package's dataclasses, field for field
with the same defaults and properties: one ``ModelConfig`` covers an
architecture through a periodic layer pattern, each ``LayerSlot`` a
(mixer, ffn) pair, the decoder stack ``layer_pattern`` repeated
``n_layers / len(layer_pattern)`` times.  ``MLAConfig`` and
``SSMConfig`` are shapes only here: the port runs the ``attn`` mixer
with the ``dense`` and ``moe`` ffns (ROADMAP.md Queue 1 item 12d brings
MLA and Mamba-2).  ``OptimizerConfig`` and ``TrainConfig`` drive
training (``launch/steps.py``, ``launch/train.py``).  ``ParallelConfig``
carries its fields only: the training step reads ``grad_accum``, and the
port's models run on one device (ROADMAP.md Queue 3 D19); the mesh and
sharding wait for item 12e.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention geometry (shape only in the port)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture of experts.  ``dispatch``: "onehot" ranks slots within
    their expert by a one-hot cumsum; "sample_sort" by the deterministic
    sample sort; every other value (the reference's "xla_sort" and
    "dense") by a stable library argsort."""

    n_experts: int = 64
    top_k: int = 6
    d_ff_expert: int = 1408
    n_shared_experts: int = 0  # shared-expert d_ff = n_shared * d_ff_expert
    capacity_factor: float = 1.25
    dispatch: Literal["sample_sort", "xla_sort", "dense"] = "sample_sort"
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block geometry (shape only in the port)."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class LayerSlot:
    mixer: Literal["attn", "mla", "mamba", "none"] = "attn"
    ffn: Literal["dense", "moe", "none"] = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int = 0  # 0 -> d_model // n_heads
    attn_bias: bool = False  # qwen2: bias on QKV projections
    rope_theta: float = 10000.0
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    activation: Literal["swiglu", "gelu"] = "swiglu"
    tie_embeddings: bool = False
    layer_pattern: tuple[LayerSlot, ...] = (LayerSlot(),)
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # encoder-decoder: the encoder reuses d_model/heads/d_ff
    n_encoder_layers: int = 0
    encoder_positions: int = 1500
    # modality frontend stub: precomputed prefix embeddings
    frontend: Literal["none", "audio", "vision"] = "none"
    frontend_len: int = 0
    # dtypes
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"  # activation/compute dtype
    # memory
    remat: Literal["none", "full", "dots"] = "full"
    sub_quadratic: bool = False
    attn_chunk: int = 1024  # KV block of the chunked attention
    loss_chunk: int = 2048
    scan_layers: bool = True

    @property
    def dh(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        """Embedding tables padded to a multiple of 256; the pad logits
        are masked in unembed."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.layer_pattern):
            raise ValueError(
                f"n_layers {self.n_layers} is not a multiple of the "
                f"layer pattern's {len(self.layer_pattern)} slots")
        return self.n_layers // len(self.layer_pattern)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"] = "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh and sharding policy (fields only in the port: item 12e)."""

    mesh_shape: tuple[int, ...] = (16, 16)
    mesh_axes: tuple[str, ...] = ("data", "model")
    fsdp: bool = False  # shard the "embed" dim of params over data axis
    fsdp_axes: tuple[str, ...] = ("data",)
    remat_scan: bool = True
    grad_accum: int = 1  # microbatches summed into one step
    compress_grads: bool = False  # int8 all-reduce w/ error feedback (DP path)

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    moment_dtype: str = "float32"  # "bfloat16" for low-mem (jamba-398b)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    log_every: int = 10
    ckpt_every: int = 100
    ckpt_dir: str = "/tmp/repro_ckpt"
    ckpt_keep: int = 3
    seed: int = 0
    optimizer: OptimizerConfig = OptimizerConfig()


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """Everything a launcher needs for one ``--arch`` id."""

    model: ModelConfig
    shapes: tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: str = ""
    fsdp: bool = False
    moment_dtype: str = "float32"
