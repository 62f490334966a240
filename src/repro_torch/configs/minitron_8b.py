"""minitron-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=16384
vocab=256000; pruned nemotron (squared-ReLU).  [arXiv:2407.14679; hf]"""
from ._common import full, smoke

CONFIG = full(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=256000, act="relu2")

SMOKE = smoke(
    name="minitron-smoke", family="dense",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
    d_ff=64, vocab=128, act="relu2")
