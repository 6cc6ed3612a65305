"""phi3-medium-14b — dense RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.

Note: 40 heads / kv=10 are NOT divisible by the production TP degree (16); the
sharding rules fall back to row-parallel attention for this arch (see
repro/sharding/rules.py and DESIGN.md §Arch-applicability).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab=100352,
)
