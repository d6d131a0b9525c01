"""Architecture registry: --arch <id> -> ArchConfig (+ reduced SMOKE).

The port registers the architectures whose layers it runs (attention
with MoE); the reference's other ids raise ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

ARCHS = {
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
}

# The reference's ids whose layers (dense-only stacks, MLA, Mamba-2,
# the encoder-decoder, the frontends) the port does not run yet.
NOT_YET_PORTED = (
    "starcoder2-15b", "llama3.2-3b", "qwen2-1.5b", "minicpm3-4b",
    "whisper-large-v3", "mamba2-2.7b", "jamba-1.5-large-398b",
    "internvl2-26b",
)


def _module(name: str):
    if name in ARCHS:
        return importlib.import_module(ARCHS[name])
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ROADMAP.md Queue 1 item 12); "
            f"the port runs {sorted(ARCHS)}")
    raise KeyError(f"unknown arch {name!r}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def all_archs():
    return list(ARCHS)
