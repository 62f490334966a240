"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064; phi3-mini backbone + CLIP frontend STUB (input_specs provides
precomputed patch embeddings).  [hf:microsoft/Phi-3-vision-128k-instruct]"""
from ._common import full, smoke

CONFIG = full(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_head=96,
    d_ff=8192, vocab=32064, act="swiglu", frontend="vision",
    frontend_tokens=576)          # 24x24 CLIP patches

SMOKE = smoke(
    name="phi3v-smoke", family="vlm",
    n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_head=8,
    d_ff=32, vocab=128, act="swiglu", frontend="vision", frontend_tokens=4)
