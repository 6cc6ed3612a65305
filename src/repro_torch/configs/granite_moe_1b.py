"""granite-moe-1b-a400m — MoE 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
High top-k (8/32) stresses the dispatch all-to-all — the most
collective-bound MoE cell in the assignment.
"""
from repro_torch.configs.base import LMConfig, MoEConfig

CONFIG = LMConfig(
    arch_id="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    moe=MoEConfig(num_experts=32, top_k=8, capacity_factor=1.25),
)
