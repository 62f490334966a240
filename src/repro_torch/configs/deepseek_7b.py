"""deepseek-7b [dense]: 30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400; llama-style SwiGLU.  [arXiv:2401.02954; hf]"""
from ._common import full, smoke

CONFIG = full(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_head=128,
    d_ff=11008, vocab=102400, act="swiglu")

SMOKE = smoke(
    name="deepseek-smoke", family="dense",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_head=8,
    d_ff=48, vocab=128, act="swiglu")
