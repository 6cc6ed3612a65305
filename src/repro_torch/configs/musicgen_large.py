"""musicgen-large — audio decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048.
Backbone only per assignment: EnCodec/ T5-conditioning frontends are STUBS;
``input_specs()`` provides precomputed conditioning-frame embeddings as a
prefix and the token stream is the (delay-interleaved) codebook stream.
MusicGen uses learned positional embeddings and non-gated GELU MLPs.
"""
from repro_torch.configs.base import LMConfig

CONFIG = LMConfig(
    arch_id="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=2048,
    act="gelu",
    gated_mlp=False,
    norm_type="layernorm",
    pos_emb="learned",
    prefix_len=64,    # stubbed conditioning prefix
)
