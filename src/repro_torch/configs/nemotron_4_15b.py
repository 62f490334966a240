"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000; squared-ReLU MLP.  [arXiv:2402.16819; unverified]"""
from ._common import full, smoke

CONFIG = full(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=24576, vocab=256000, act="relu2")

SMOKE = smoke(
    name="nemotron-smoke", family="dense",
    n_layers=2, d_model=24, n_heads=4, n_kv_heads=2, d_head=6,
    d_ff=48, vocab=128, act="relu2")
