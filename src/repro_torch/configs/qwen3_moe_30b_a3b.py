"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) vocab=151936.

128 experts, top-8, expert d_ff 768 [hf:Qwen/Qwen3-30B-A3B].  MoE
dispatch = the deterministic sample sort.  ``head_dim`` is left 0, so
dh = 2048 / 32 = 64 where the published model has 128: the reference
config's shape, kept (ROADMAP.md Queue 3 R6).
"""

from repro_torch.config import ArchConfig, LayerSlot, ModelConfig, MoEConfig
from repro_torch.configs.common import LM_SHAPES, SKIP_FULL_ATTN, smoke_shrink

MODEL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab=151936,
    rope_theta=1000000.0,
    layer_pattern=(LayerSlot("attn", "moe"),),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                  dispatch="sample_sort"),
)

CONFIG = ArchConfig(model=MODEL, shapes=LM_SHAPES, skip_notes=SKIP_FULL_ATTN)
SMOKE = smoke_shrink(MODEL)
