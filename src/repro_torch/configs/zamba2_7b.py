"""zamba2-7b [hybrid]: 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 layers + shared attention block.
[arXiv:2411.15242; unverified]

MPC adaptation: Mamba2 selective scan -> retention-style matrix state with
public per-head decay + secret gates (DESIGN.md Arch-applicability)."""
from ._common import full, smoke

CONFIG = full(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, ssm_state=64, shared_attn_every=9,
    act="swiglu")

SMOKE = smoke(
    name="zamba2-smoke", family="hybrid",
    n_layers=4, d_model=32, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=128, ssm_state=8, shared_attn_every=2, act="swiglu")
