"""deepseek-7b — dense llama-arch [arXiv:2401.02954; hf].

30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab=102400,
)
