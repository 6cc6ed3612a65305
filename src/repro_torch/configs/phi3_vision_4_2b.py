"""phi-3-vision-4.2b — VLM backbone [hf:microsoft/Phi-3-vision-128k-instruct; hf].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
phi3-mini backbone + CLIP frontend. Per assignment the modality frontend is a
STUB: ``input_specs()`` provides precomputed patch embeddings that the backbone
consumes as a sequence prefix; loss is computed on text positions only.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab=32064,
    prefix_len=144,   # stubbed CLIP patch-embedding prefix (12x12 pooled patches)
)
