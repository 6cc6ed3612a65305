"""granite-4.0-h-micro — a Mamba-2 + GQA hybrid with muP multipliers
[hf:ibm-granite/granite-4.0-h-micro, config.json].

40 layers, d_model=2048, vocab=100352, tied embeddings, RMSNorm (eps 1e-5).
Attention at layers 5, 15, 25 and 35: 32 query heads and 8 KV heads of 64,
no positional encoding, no biases, softmax scale 1/64. The other 36 layers
are Mamba-2: 64 heads of 64 (d_inner 4096), state 128, one B/C group, a
4-tap conv with bias, a gated RMSNorm. Every layer has its own SwiGLU MLP
(8192). Embedding x 12, each mixer's and MLP's output x 0.22 before its
residual add, logits / 8. The SSD chunk is 128, the scan kernel's largest
(the published 256 is a tile of the upstream kernels: the scan's sum does
not depend on it). The JAX package has no counterpart.
"""
from repro_torch.configs.base import HybridConfig, LMConfig, SSMConfig

CONFIG = LMConfig(
    arch_id="granite-4.0-h-micro",
    family="granite_hybrid",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab=100352,
    norm_type="rmsnorm",
    norm_eps=1e-5,
    pos_emb="none",
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.015625,
    logits_scaling=8.0,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=128),
    hybrid=HybridConfig(attn_layers=(5, 15, 25, 35)),
    subquadratic=True,
)
