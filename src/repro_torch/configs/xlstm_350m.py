"""xlstm-350m — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.
d_ff=0 per assignment: all FFN capacity lives inside the blocks (mLSTM
up-projection factor 2; sLSTM post-cell GLU factor 2). Sub-quadratic:
runs the long_500k cell (recurrent O(1)-state decode).
"""
from repro_torch.configs.base import LMConfig, XLSTMConfig

CONFIG = LMConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab=50304,
    pos_emb="none",
    xlstm=XLSTMConfig(proj_factor_m=2, ff_factor_s=2, chunk_size=128,
                      slstm_every=2),
    subquadratic=True,
)
