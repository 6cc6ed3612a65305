"""zamba2-1.2b — hybrid Mamba2 + shared attention blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
38 Mamba-2 blocks; a single parameter-shared attention+MLP block is applied
every `attn_every` SSM blocks (Zamba-style weight sharing). Sub-quadratic:
runs the long_500k cell with a sequence-sharded KV cache for the shared
attention block.
"""
from repro_torch.configs.base import LMConfig, SSMConfig, HybridConfig

CONFIG = LMConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=128),
    hybrid=HybridConfig(attn_every=6),
    subquadratic=True,
)
