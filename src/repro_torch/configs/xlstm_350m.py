"""xlstm-350m [ssm]: 24L d_model=1024 4H vocab=50304; alternating
sLSTM + mLSTM blocks (d_ff=0: recurrent blocks carry the capacity).
[arXiv:2405.04517; unverified]

MPC adaptation: mLSTM -> retention-style matrix memory, sLSTM -> scalar
state, both with public per-head decay + secret sigmoid gates."""
from ._common import full, smoke

CONFIG = full(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, ssm_state=64)

SMOKE = smoke(
    name="xlstm-smoke", family="ssm",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=128, ssm_state=8)
