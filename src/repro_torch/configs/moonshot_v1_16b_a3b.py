"""moonshot-v1-16b-a3b [moe]: 48L d=2048 16H (kv=16) vocab=163840.

Moonlight-style MoE: 64 experts, top-6, expert d_ff 1408; MHA + RoPE
[hf:moonshotai/Moonlight-16B-A3B].  Every layer MoE.  MoE dispatch =
the deterministic sample sort.
"""

from repro_torch.config import ArchConfig, LayerSlot, ModelConfig, MoEConfig
from repro_torch.configs.common import LM_SHAPES, SKIP_FULL_ATTN, smoke_shrink

MODEL = ModelConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    layer_pattern=(LayerSlot("attn", "moe"),),
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                  dispatch="sample_sort"),
)

CONFIG = ArchConfig(model=MODEL, shapes=LM_SHAPES, skip_notes=SKIP_FULL_ATTN)
SMOKE = smoke_shrink(MODEL)
