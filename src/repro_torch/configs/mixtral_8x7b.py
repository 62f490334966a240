"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088; hf]"""
from ._common import full, smoke

CONFIG = full(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=32000, n_experts=8, top_k=2, act="swiglu",
    window=4096, rope_theta=1e6)

SMOKE = smoke(
    name="mixtral-smoke", family="moe",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
    d_ff=32, vocab=128, n_experts=4, top_k=2, act="swiglu", window=4)
