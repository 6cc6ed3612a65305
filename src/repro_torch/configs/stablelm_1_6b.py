"""stablelm-1.6b — dense [hf:stabilityai/stablelm-2-1_6b; unverified].

24L d_model=2048 32H (GQA kv=32) d_ff=5632 vocab=100352.
StableLM-2 uses LayerNorm and partial rotary embeddings (25% of head_dim).
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab=100352,
    norm_type="layernorm",
    rope_fraction=0.25,
)
