"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936; qk_norm.  [hf:Qwen/Qwen3-8B; hf]"""
from ._common import full, smoke

CONFIG = full(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab=151936, act="swiglu", qk_norm=True, rope_theta=1e6)

SMOKE = smoke(
    name="qwen3-smoke", family="dense",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
    d_ff=64, vocab=128, act="swiglu", qk_norm=True)
