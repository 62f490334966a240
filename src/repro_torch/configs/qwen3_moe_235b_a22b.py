"""qwen3-moe-235b-a22b [moe]: 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from ._common import full, smoke

CONFIG = full(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab=151936, n_experts=128, top_k=8, act="swiglu",
    qk_norm=True, rope_theta=1e6)

SMOKE = smoke(
    name="qwen3-moe-smoke", family="moe",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
    d_ff=16, vocab=128, n_experts=4, top_k=2, act="swiglu", qk_norm=True)
